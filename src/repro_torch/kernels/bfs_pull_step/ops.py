"""Wrappers of the B2 pull kernel (bfs_pull_step/kernel.cu).

``bfs_pull_step_rows`` keeps the kernel's contract (``ref.py``): on a CUDA
tensor it launches the kernel, on a CPU tensor it runs the plain version,
on anything else it raises. ``launches`` counts kernel launches. With
``parents=False`` (closure mode) no parent is computed or written and
``None`` stands in its place.
``multi_bfs_pull_step`` and ``bfs_pull_step`` are the bool-interface
drop-ins for ``core.bfs.multi_bfs_step_pull_jnp`` / ``bfs_step_pull_jnp``;
they pack the live frontier into words first, as the JAX wrappers do.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import pack_bits
from repro_torch.kernels import _build
from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref

launches = 0


def _launch(frontier_words, adj_in_rows, alive, visited, parents=True):
    global launches
    q, w = frontier_words.shape
    rows = adj_in_rows.shape[0]
    dev = adj_in_rows.device
    for t, name, dt, shape in (
            (frontier_words, "frontier_words", torch.int32, (q, w)),
            (adj_in_rows, "adj_in_rows", torch.int32, (rows, w)),
            (alive, "alive", torch.bool, (rows,)),
            (visited, "visited", torch.bool, (q, rows))):
        _build.check_tensor(t, name, dt, shape, dev)
    new = torch.empty((q, rows), dtype=torch.bool, device=dev)
    parent = (torch.empty((q, rows), dtype=torch.int32, device=dev)
              if parents else None)
    # fany int32[W], nonempty int32[Q], the transposed frontier int32[W, Q]
    scratch = torch.empty((w + q + w * q,), dtype=torch.int32, device=dev)
    _build.launch("bfs_pull_step", "bfs_pull_step_launch", dev,
                  frontier_words, adj_in_rows, alive, visited, new, parent,
                  scratch, q, rows, w, int(parents))
    launches += 1
    return new, parent


def bfs_pull_step_rows(frontier_words, adj_in_rows, alive, visited,
                       parents: bool = True):
    """B2: (new bool[Q, R], parent int32[Q, R] global ids, or None with
    ``parents=False``)."""
    if adj_in_rows.is_cuda:
        return _launch(frontier_words, adj_in_rows, alive, visited, parents)
    if adj_in_rows.device.type == "cpu":
        return bfs_pull_step_ref(frontier_words, adj_in_rows, alive, visited,
                                 parents=parents)
    raise ValueError(f"no B2 kernel for device {adj_in_rows.device}")


def multi_bfs_pull_step(frontiers, adj_in_packed, alive, visited,
                        parents: bool = True):
    """frontiers bool[Q, V], adj_in_packed int32[V, W], alive bool[V],
    visited bool[Q, V] -> (new bool[Q, V], parent int32[Q, V] or None with
    ``parents=False``)."""
    fw = pack_bits(frontiers & alive[None, :])
    return bfs_pull_step_rows(fw, adj_in_packed, alive, visited,
                              parents=parents)


def bfs_pull_step(frontier, adj_in_packed, alive, visited):
    """Single-query form: bool[V] inputs -> (new bool[V], parent int32[V])."""
    new, parent = multi_bfs_pull_step(frontier[None], adj_in_packed, alive,
                                      visited[None])
    return new[0], parent[0]
