"""Plain PyTorch versions of the B1 (packed) and B6 (dense) push supersteps
(the kernels' contracts).

B1:

frontiers bool[Q, R], adj_packed int32[R, W] (R == V or a row slice),
alive bool[V], visited bool[Q, V] with V <= 32 * W
-> (new bool[Q, V], parent int32[Q, V], reach_words int32[Q, W]):

  reach_words[q] = OR of the RAW words of q's frontier rows (no liveness
                   mask: the sharded exchange carries physical reach)
  new[q, c]      = bit c of reach_words[q] & alive[c] & ~visited[q, c]
  parent[q, c]   = smallest frontier row of q (relative to the slice) with
                   bit c set, where new; -1 elsewhere (None with
                   ``parents=False``: closure mode computes no parent)

B6: frontiers bool[Q, R], adj uint8[R, V] (R == V or a row slice),
alive bool[V], visited bool[Q, V] -> (new bool[Q, V], parent int32[Q, V]):

  new[q, c]      = (some frontier row r of q has adj[r, c] != 0)
                   & alive[c] & ~visited[q, c]
  parent[q, c]   = the smallest such r (relative to the slice), where new;
                   -1 elsewhere (None with ``parents=False``)

Both read only frontier rows, in ascending chunks sized so the transient
stays under ``budget`` bytes, so they also run at full size.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import (INT32_MAX, WORD_BITS, or_reduce,
                                    unpack_bits)

_BUDGET = 256 * 1024 * 1024


def multi_bfs_step_packed_ref(frontiers, adj_packed, alive, visited,
                              parents: bool = True, budget: int = _BUDGET):
    q = frontiers.shape[0]
    w = adj_packed.shape[1]
    v = alive.shape[0]
    dev = adj_packed.device
    reach = torch.zeros((q, w), dtype=torch.int32, device=dev)
    parent = (torch.full((q, v), INT32_MAX, dtype=torch.int32, device=dev)
              if parents else None)
    rows = torch.nonzero(frontiers.any(0)).flatten()   # ascending
    chunk = max(1, budget // ((2 * WORD_BITS if parents else 4) * q * w))
    for i in range(0, rows.numel(), chunk):
        rc = rows[i:i + chunk]
        a = adj_packed[rc]                              # [c, W]
        f = frontiers[:, rc]                            # [Q, c]
        sel = torch.where(f[:, :, None], a[None], 0)
        reach |= or_reduce(sel, 1)
        if not parents:
            continue
        m = f[:, :, None] & unpack_bits(a, v)[None]     # [Q, c, V]
        first = rc[m.to(torch.int8).argmax(1)]          # first = smallest row
        cand = torch.where(m.any(1), first.to(torch.int32), INT32_MAX)
        parent = torch.minimum(parent, cand)
    new = unpack_bits(reach, v) & alive[None, :] & ~visited
    return new, torch.where(new, parent, -1) if parents else None, reach


def multi_bfs_step_ref(frontiers, adj, alive, visited, parents: bool = True,
                       budget: int = _BUDGET):
    q = frontiers.shape[0]
    v = adj.shape[1]
    dev = adj.device
    parent = (torch.full((q, v), INT32_MAX, dtype=torch.int32, device=dev)
              if parents else None)
    reach = torch.zeros((q, v), dtype=torch.bool, device=dev)
    rows = torch.nonzero(frontiers.any(0)).flatten()   # ascending
    chunk = max(1, budget // max(1, q * v))
    for i in range(0, rows.numel(), chunk):
        rc = rows[i:i + chunk]
        # repro-lint: allow(traversable-predicate) — raw rows; `new` masks
        m = frontiers[:, rc, None] & (adj[rc] != 0)[None]    # [Q, c, V]  # repro-torch-lint: allow(traversable-predicate) — raw rows; `new` masks
        hit = m.any(1)
        reach |= hit
        if not parents:
            continue
        first = rc[m.to(torch.int8).argmax(1)]          # first = smallest row
        cand = torch.where(hit, first.to(torch.int32), INT32_MAX)
        parent = torch.minimum(parent, cand)
    new = reach & alive[None, :] & ~visited
    return new, torch.where(new, parent, -1) if parents else None
