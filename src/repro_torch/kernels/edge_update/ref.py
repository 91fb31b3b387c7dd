"""Plain PyTorch versions of the B9 (dense) and B5 (packed) edge writes
(the kernels' contract; the JAX package's ``edge_update/ref.py``).

rows, cols, vals, mask int32[B]; a lane fires when mask > 0, and only
firing lanes are read:

  B9 edge_update_ref(adj uint8[R, C], ecnt int32[R], ...)
       adj[row, col] = vals cast to uint8 (modulo 256)
  B5 edge_update_packed_ref(adj_packed int32[R, W], ecnt int32[R], ...)
       bit col of the row: set when vals > 0, cleared otherwise

On a duplicate (row, col) the last firing lane wins (lane order is the
batch's linearization order); ecnt[row] gains 1 for every firing lane,
duplicates included. A firing lane whose row is out of range changes
nothing; one whose column is out of range bumps ecnt alone. Returns new
tensors; the inputs are not written. Neither form unpacks or scans the
matrix: only the touched cells or words are read and written.
"""
from __future__ import annotations

import torch

from repro_torch.core.graph import WORD_BITS, wrap_int32


def _fired(ecnt, rows, cols, mask, n_rows, n_cols):
    """(ecnt after the bumps, in-range mask of the firing lanes, their rows
    and columns as int64, index of the last lane of every distinct target
    among the in-range ones)."""
    fire = mask > 0
    r, c = rows[fire].long(), cols[fire].long()
    row_ok = (r >= 0) & (r < n_rows)
    ecnt = ecnt.clone()
    ecnt.index_add_(0, r[row_ok], torch.ones_like(r[row_ok],
                                                  dtype=ecnt.dtype))
    ok = row_ok & (c >= 0) & (c < n_cols)
    flat = r[ok] * n_cols + c[ok]
    order = torch.argsort(flat, stable=True)   # lane order within a target
    s = flat[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[:-1] != s[1:]
    return ecnt, fire, ok, r[ok], c[ok], order[last]


def edge_update_ref(adj, ecnt, rows, cols, vals, mask):
    ecnt, fire, ok, r, c, win = _fired(ecnt, rows, cols, mask, adj.shape[0],
                                       adj.shape[1])
    adj = adj.clone()
    adj[r[win], c[win]] = vals[fire][ok][win].to(adj.dtype)
    return adj, ecnt


def edge_update_packed_ref(adj_packed, ecnt, rows, cols, vals, mask):
    n_rows, w = adj_packed.shape
    ecnt, fire, ok, r, c, win = _fired(ecnt, rows, cols, mask, n_rows,
                                       w * WORD_BITS)
    r, c, v = r[win], c[win], vals[fire][ok][win]
    bit = torch.ones_like(c) << (c % WORD_BITS)
    words, inv = torch.unique(r * w + c // WORD_BITS, return_inverse=True)
    # winners have distinct bits, so a sum of bits per word is their OR
    zero = torch.zeros_like(words)
    set_bits = zero.index_add(0, inv, torch.where(v > 0, bit, 0))
    clear_bits = zero.index_add(0, inv, torch.where(v > 0, 0, bit))
    out = adj_packed.clone()
    flat = out.view(-1)
    cur = flat[words].to(torch.int64) & 0xFFFFFFFF
    flat[words] = wrap_int32((cur & ~clear_bits) | set_bits)
    return out, ecnt
