"""Wrappers of the B1 (packed) and B6 (dense) push kernels
(bfs_multi_step/kernel.cu).

``multi_bfs_step_packed_kernel`` (B1) and ``multi_bfs_step`` (B6) keep the
kernels' contracts (see ``ref.py``): on a CUDA tensor each launches its
kernel, on a CPU tensor it runs the plain version, on anything else it
raises. ``launches`` (B1) and ``dense_launches`` (B6) count kernel
launches. ``multi_bfs_step_packed`` is the bool-interface drop-in for
``core.bfs.multi_bfs_step_packed_jnp``. No query or column padding is
needed: the kernels take any Q and mask columns >= V themselves. B1 and
B6 take ``parents=False`` (closure mode): no parent is computed or
written and ``None`` stands in its place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bfs_multi_step.ref import (multi_bfs_step_packed_ref,
                                                    multi_bfs_step_ref)

launches = 0
dense_launches = 0


def _launch(frontiers, adj_packed, alive, visited, parents=True):
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
    parent = (torch.empty((q, v), dtype=torch.int32, device=dev)
              if parents else None)
    reach = torch.empty((q, w), dtype=torch.int32, device=dev)
    scratch = torch.empty((q, -(-rows // 32)), dtype=torch.int32, device=dev)
    _build.launch("bfs_multi_step", "multi_bfs_step_packed_launch", dev,
                  frontiers, adj_packed, alive, visited, new, parent, reach,
                  scratch, q, rows, w, v, int(parents))
    launches += 1
    return new, parent, reach


def multi_bfs_step_packed_kernel(frontiers, adj_packed, alive, visited,
                                 parents: bool = True):
    """B1: (new bool[Q, V], parent int32[Q, V] slice-relative or None with
    ``parents=False``, reach_words int32[Q, W] raw)."""
    if adj_packed.is_cuda:
        return _launch(frontiers, adj_packed, alive, visited, parents)
    if adj_packed.device.type == "cpu":
        return multi_bfs_step_packed_ref(frontiers, adj_packed, alive, visited,
                                         parents=parents)
    raise ValueError(f"no B1 kernel for device {adj_packed.device}")


def multi_bfs_step_packed(frontiers, adj_packed, alive, visited,
                          parents: bool = True):
    """Drop-in for ``core.bfs.multi_bfs_step_packed_jnp``: frontiers
    bool[Q, R], adj_packed int32[R, W], alive bool[V], visited bool[Q, V]
    -> (new bool[Q, V], parent int32[Q, V] or None with
    ``parents=False``)."""
    new, parent, _ = multi_bfs_step_packed_kernel(frontiers, adj_packed,
                                                  alive, visited,
                                                  parents=parents)
    return new, parent


def dense_scratch(q: int, rows: int, device):
    """The dense launcher's scratch (``dense.cuh``): per group of 64
    queries a uint64 query mask per row, and int32 ballot words (one per
    32 rows), active-row counts (one per 256 rows), the list length and
    the active-row list (``scratch_ints``)."""
    groups = -(-q // 64)
    qmask = torch.empty((groups, rows), dtype=torch.int64, device=device)
    ints = torch.empty((groups * (-(-rows // 32) + -(-rows // 256) + 1
                                  + rows),), dtype=torch.int32, device=device)
    return qmask, ints


def _launch_dense(frontiers, adj, alive, visited, parents=True):
    global dense_launches
    q, rows = frontiers.shape
    v = adj.shape[1]
    dev = adj.device
    for t, name, dt, shape in ((frontiers, "frontiers", torch.bool, (q, rows)),
                               (adj, "adj", torch.uint8, (rows, v)),
                               (alive, "alive", torch.bool, (v,)),
                               (visited, "visited", torch.bool, (q, v))):
        _build.check_tensor(t, name, dt, shape, dev)
    new = torch.empty((q, v), dtype=torch.bool, device=dev)
    parent = (torch.empty((q, v), dtype=torch.int32, device=dev)
              if parents else None)
    qmask, scratch = dense_scratch(q, rows, dev)
    _build.launch("bfs_multi_step", "multi_bfs_step_launch", dev, frontiers,
                  adj, alive, visited, new, parent, qmask, scratch, q, rows,
                  v, int(parents))
    dense_launches += 1
    return new, parent


def multi_bfs_step(frontiers, adj, alive, visited, parents: bool = True):
    """B6, the drop-in for ``core.bfs.multi_bfs_step_jnp`` on the dense
    view: frontiers bool[Q, R], adj uint8[R, V], alive bool[V], visited
    bool[Q, V] -> (new bool[Q, V], parent int32[Q, V] slice-relative, or
    None with ``parents=False``)."""
    if adj.is_cuda:
        return _launch_dense(frontiers, adj, alive, visited, parents)
    if adj.device.type == "cpu":
        return multi_bfs_step_ref(frontiers, adj, alive, visited,
                                  parents=parents)
    raise ValueError(f"no B6 kernel for device {adj.device}")
