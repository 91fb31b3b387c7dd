"""Plain PyTorch version of the B2 pull superstep (the kernel's contract).

frontier_words int32[Q, W] (packed frontier & alive), adj_in_rows
int32[R, W] (R == V or a row slice), alive bool[R], visited bool[Q, R]
-> (new bool[Q, R], parent int32[Q, R]):

  hit[q, r]    = any word of adj_in_rows[r] & frontier_words[q] nonzero
  new[q, r]    = hit & alive[r] & ~visited[q, r]
  parent[q, r] = 32 * w + ctz of the first nonzero such word (a GLOBAL
                 source id), where new; -1 elsewhere

With ``parents=False`` the parent is not computed and ``None`` stands in
its place. Only rows some query still has to visit are read, in chunks
sized so the [Q, rows, W] transient stays under ``budget`` bytes.
"""
from __future__ import annotations

import torch

from repro_torch.core.bfs import ctz32
from repro_torch.core.graph import WORD_BITS

_BUDGET = 256 * 1024 * 1024


def bfs_pull_step_ref(frontier_words, adj_in_rows, alive, visited,
                      parents: bool = True, budget: int = _BUDGET):
    q, w = frontier_words.shape
    dev = adj_in_rows.device
    new = torch.zeros(visited.shape, dtype=torch.bool, device=dev)
    parent = (torch.full(visited.shape, -1, dtype=torch.int32, device=dev)
              if parents else None)
    rows = torch.nonzero(alive & (~visited).any(0)).flatten()
    chunk = max(1, budget // (8 * q * w))
    for i in range(0, rows.numel(), chunk):
        rc = rows[i:i + chunk]
        cand = adj_in_rows[rc][None] & frontier_words[:, None, :]  # [Q, c, W]
        nz = cand != 0
        hit = nz.any(2) & ~visited[:, rc]
        new[:, rc] = hit
        if parents:
            first = nz.to(torch.int8).argmax(2, keepdim=True)      # [Q, c, 1]
            word = cand.gather(2, first)[..., 0]
            p = first[..., 0].to(torch.int32) * WORD_BITS + ctz32(word)
            parent[:, rc] = torch.where(hit, p, -1)
    return new, parent
