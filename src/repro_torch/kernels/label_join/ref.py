"""Plain PyTorch versions of the label joins (the kernels' contracts).

  label_join_ref(out_rows, in_rows)          B8, dense
      out_rows/in_rows int32[Q, L] (label slabs: an entry > 0 is a label)
  label_join_packed_ref(out_words, in_words)  B4, packed
      out_words/in_words int32[Q, W] (label bitsets stored as int32 words)
  label_join_slots_ref(out_label, in_label, alive, src, dst)  B4 by slot
      out_label/in_label int32[V, W], alive bool[V], src/dst int32[Q]

Each returns (hits int32[Q], hub int32[Q]): hits = number of common
landmarks (2-hop witnesses), hub = smallest common landmark index, -1 when
there is none. B8 counts a landmark where both entries are ``> 0``, as
JAX's kernel and oracle do (zero and negative entries are not labels). A
packed word whose only set bit is bit 31 is negative in int32 storage, so
the packed forms test ``!= 0``. The slot form also returns the
endpoint flags (src_ok, dst_ok bool[Q]: ``endpoint_ok``) and joins the
rows ``slot_rows`` gathers.
"""
from __future__ import annotations

import torch

from repro_torch.core.bfs import ctz32
from repro_torch.core.graph import INT32_MAX, WORD_BITS, popcount


def _empty(q: int, device):
    return (torch.zeros((q,), dtype=torch.int32, device=device),
            torch.full((q,), -1, dtype=torch.int32, device=device))


def label_join_ref(out_rows, in_rows):
    q, l = out_rows.shape
    if l == 0:
        return _empty(q, out_rows.device)
    common = (out_rows > 0) & (in_rows > 0)
    hits = common.sum(1, dtype=torch.int32)
    ids = torch.arange(l, dtype=torch.int32, device=out_rows.device)
    hub = torch.where(common, ids[None, :], INT32_MAX).amin(1)
    return hits, torch.where(hits > 0, hub, -1).to(torch.int32)


def label_join_packed_ref(out_words, in_words):
    q, w = out_words.shape
    if w == 0:
        return _empty(q, out_words.device)
    common = out_words & in_words
    hits = popcount(common).sum(1, dtype=torch.int32)
    lane0 = torch.arange(w, dtype=torch.int32,
                         device=out_words.device) * WORD_BITS
    cand = torch.where(common != 0, lane0[None, :] + ctz32(common), INT32_MAX)
    hub = cand.amin(1)
    return hits, torch.where(hits > 0, hub, -1).to(torch.int32)


def endpoint_ok(alive, slots):
    """bool[Q]: the slot is >= 0 and alive (clamped into range first)."""
    return (slots >= 0) & alive[slots.clamp(0, alive.shape[0] - 1)]


def slot_rows(labels, slots, ok):
    """The label words of ``slots``, zero where the endpoint is not ok."""
    return torch.where(ok[:, None],
                       labels[slots.clamp(0, labels.shape[0] - 1)], 0)


def label_join_slots_ref(out_label, in_label, alive, src, dst):
    sok, dok = endpoint_ok(alive, src), endpoint_ok(alive, dst)
    hits, hub = label_join_packed_ref(slot_rows(out_label, src, sok),
                                      slot_rows(in_label, dst, dok))
    return hits, hub, sok, dok
