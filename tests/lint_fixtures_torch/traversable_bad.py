"""Deliberate raw adjacency liveness tests (lint fixture)."""


def bad_edge_present(adj, u, w):
    return adj[u, w] > 0  # LINT-EXPECT: traversable-predicate


def bad_packed_bit(adj_packed, u, word, bit):
    return (adj_packed[u, word] >> bit) & 1 != 0  # LINT-EXPECT: traversable-predicate


def fine_unrelated(x):
    return x > 0
