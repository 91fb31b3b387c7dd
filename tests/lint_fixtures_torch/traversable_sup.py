"""Suppressed raw adjacency test (lint fixture)."""


def allowed_physical_read(adj_packed, u, w):
    # physical-bit bookkeeping, not a liveness decision
    return adj_packed[u, w] > 0  # repro-torch-lint: allow(traversable-predicate)
