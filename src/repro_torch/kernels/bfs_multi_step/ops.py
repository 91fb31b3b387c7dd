"""Wrappers of the B1 push kernel (bfs_multi_step/kernel.cu).

``multi_bfs_step_packed_kernel`` keeps the kernel's full contract (see
``ref.py``): on a CUDA tensor it launches the kernel, on a CPU tensor it
runs the plain version, on anything else it raises. ``launches`` counts
kernel launches. ``multi_bfs_step_packed`` is the bool-interface drop-in
for ``core.bfs.multi_bfs_step_packed_jnp``. No query or column padding is
needed: the kernel takes any Q and masks columns >= V itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bfs_multi_step.ref import multi_bfs_step_packed_ref

launches = 0


def _launch(frontiers, adj_packed, alive, visited):
    global launches
    q, rows = frontiers.shape
    w = adj_packed.shape[1]
    v = alive.shape[0]
    dev = adj_packed.device
    if v > 32 * w:
        raise ValueError(f"alive covers {v} columns, adjacency {32 * w}")
    for t, name, dt, shape in ((frontiers, "frontiers", torch.bool, (q, rows)),
                               (adj_packed, "adj_packed", torch.int32, (rows, w)),
                               (alive, "alive", torch.bool, (v,)),
                               (visited, "visited", torch.bool, (q, v))):
        _build.check_tensor(t, name, dt, shape, dev)
    new = torch.empty((q, v), dtype=torch.bool, device=dev)
    parent = torch.empty((q, v), dtype=torch.int32, device=dev)
    reach = torch.empty((q, w), dtype=torch.int32, device=dev)
    scratch = torch.empty((q, -(-rows // 32)), dtype=torch.int32, device=dev)
    _build.launch("bfs_multi_step", "multi_bfs_step_packed_launch", dev,
                  frontiers, adj_packed, alive, visited, new, parent, reach,
                  scratch, q, rows, w, v)
    launches += 1
    return new, parent, reach


def multi_bfs_step_packed_kernel(frontiers, adj_packed, alive, visited):
    """B1: (new bool[Q, V], parent int32[Q, V] slice-relative, reach_words
    int32[Q, W] raw)."""
    if adj_packed.is_cuda:
        return _launch(frontiers, adj_packed, alive, visited)
    if adj_packed.device.type == "cpu":
        return multi_bfs_step_packed_ref(frontiers, adj_packed, alive, visited)
    raise ValueError(f"no B1 kernel for device {adj_packed.device}")


def multi_bfs_step_packed(frontiers, adj_packed, alive, visited):
    """Drop-in for ``core.bfs.multi_bfs_step_packed_jnp``: frontiers
    bool[Q, R], adj_packed int32[R, W], alive bool[V], visited bool[Q, V]
    -> (new bool[Q, V], parent int32[Q, V])."""
    new, parent, _ = multi_bfs_step_packed_kernel(frontiers, adj_packed,
                                                  alive, visited)
    return new, parent
