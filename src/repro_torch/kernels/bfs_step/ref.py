"""Plain PyTorch versions of the B3 (packed) and B7 (dense) push
supersteps: the single-frontier forms of B1 and B6 (``bfs_multi_step.ref``).

B3: frontier bool[V], adj_packed int32[V, W], alive bool[V], visited
bool[V] -> (new bool[V], parent int32[V], reach_words int32[W]).
B7: frontier bool[V], adj uint8[V, V], alive bool[V], visited bool[V]
-> (new bool[V], parent int32[V]).
"""
from __future__ import annotations

from repro_torch.kernels.bfs_multi_step.ref import (multi_bfs_step_packed_ref,
                                                    multi_bfs_step_ref)


def bfs_step_packed_ref(frontier, adj_packed, alive, visited):
    new, parent, reach = multi_bfs_step_packed_ref(
        frontier[None], adj_packed, alive, visited[None])
    return new[0], parent[0], reach[0]


def bfs_step_ref(frontier, adj, alive, visited):
    new, parent = multi_bfs_step_ref(frontier[None], adj, alive,
                                     visited[None])
    return new[0], parent[0]
