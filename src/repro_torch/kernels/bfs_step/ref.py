"""Plain PyTorch version of the B3 push superstep: the single-frontier form
of B1 (``bfs_multi_step.ref``).

frontier bool[V], adj_packed int32[V, W], alive bool[V], visited bool[V]
-> (new bool[V], parent int32[V], reach_words int32[W]).
"""
from __future__ import annotations

from repro_torch.kernels.bfs_multi_step.ref import multi_bfs_step_packed_ref


def bfs_step_packed_ref(frontier, adj_packed, alive, visited):
    new, parent, reach = multi_bfs_step_packed_ref(
        frontier[None], adj_packed, alive, visited[None])
    return new[0], parent[0], reach[0]
