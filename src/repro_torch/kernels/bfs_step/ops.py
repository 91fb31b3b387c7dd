"""Wrappers of the B3 (packed) and B7 (dense) push kernels
(bfs_step/kernel.cu).

``bfs_step_packed_kernel`` (B3) and ``bfs_step`` (B7) keep the kernels'
contracts (``ref.py``): on a CUDA tensor each launches its kernel, on a
CPU tensor it runs the plain version, on anything else it raises.
``launches`` (B3) and ``dense_launches`` (B7) count kernel launches.
``bfs_step_packed`` is the bool-interface drop-in for
``core.bfs.bfs_step_packed_jnp``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bfs_multi_step.ops import dense_scratch
from repro_torch.kernels.bfs_step.ref import bfs_step_packed_ref, bfs_step_ref

launches = 0
dense_launches = 0


def _launch(frontier, adj_packed, alive, visited):
    global launches
    v, w = adj_packed.shape
    dev = adj_packed.device
    if v > 32 * w:
        raise ValueError(f"{v} rows need {-(-v // 32)} words, got {w}")
    for t, name, dt, shape in ((frontier, "frontier", torch.bool, (v,)),
                               (adj_packed, "adj_packed", torch.int32, (v, w)),
                               (alive, "alive", torch.bool, (v,)),
                               (visited, "visited", torch.bool, (v,))):
        _build.check_tensor(t, name, dt, shape, dev)
    new = torch.empty((v,), dtype=torch.bool, device=dev)
    parent = torch.empty((v,), dtype=torch.int32, device=dev)
    reach = torch.empty((w,), dtype=torch.int32, device=dev)
    _build.launch("bfs_step", "bfs_step_packed_launch", dev, frontier,
                  adj_packed, alive, visited, new, parent, reach, v, w)
    launches += 1
    return new, parent, reach


def bfs_step_packed_kernel(frontier, adj_packed, alive, visited):
    """B3: (new bool[V], parent int32[V], reach_words int32[W] raw)."""
    if adj_packed.is_cuda:
        return _launch(frontier, adj_packed, alive, visited)
    if adj_packed.device.type == "cpu":
        return bfs_step_packed_ref(frontier, adj_packed, alive, visited)
    raise ValueError(f"no B3 kernel for device {adj_packed.device}")


def bfs_step_packed(frontier, adj_packed, alive, visited):
    """Drop-in for ``core.bfs.bfs_step_packed_jnp``: frontier/alive/visited
    bool[V], adj_packed int32[V, W] -> (new bool[V], parent int32[V])."""
    new, parent, _ = bfs_step_packed_kernel(frontier, adj_packed, alive,
                                            visited)
    return new, parent


def _launch_dense(frontier, adj, alive, visited):
    global dense_launches
    v = adj.shape[0]
    dev = adj.device
    for t, name, dt, shape in ((frontier, "frontier", torch.bool, (v,)),
                               (adj, "adj", torch.uint8, (v, v)),
                               (alive, "alive", torch.bool, (v,)),
                               (visited, "visited", torch.bool, (v,))):
        _build.check_tensor(t, name, dt, shape, dev)
    new = torch.empty((v,), dtype=torch.bool, device=dev)
    parent = torch.empty((v,), dtype=torch.int32, device=dev)
    qmask, scratch = dense_scratch(1, v, dev)
    _build.launch("bfs_step", "bfs_step_launch", dev, frontier, adj, alive,
                  visited, new, parent, qmask, scratch, v)
    dense_launches += 1
    return new, parent


def bfs_step(frontier, adj, alive, visited):
    """B7, the drop-in for ``core.bfs.bfs_step_jnp`` on the dense view:
    frontier/alive/visited bool[V], adj uint8[V, V] -> (new bool[V],
    parent int32[V])."""
    if adj.is_cuda:
        return _launch_dense(frontier, adj, alive, visited)
    if adj.device.type == "cpu":
        return bfs_step_ref(frontier, adj, alive, visited)
    raise ValueError(f"no B7 kernel for device {adj.device}")
