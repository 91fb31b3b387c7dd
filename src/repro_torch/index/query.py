"""Index-side query answering, in PyTorch: the port of ``repro.index.query``
(DESIGN.md §9).

A batch of Q (src, dst) slot pairs is answered by joining the sources'
OUT label words with the destinations' IN label words: hits = popcount of
the AND-ed words, hub = the smallest common landmark. No traversal and no
adjacency read.

Join backends:

  "cuda"   B4 by slot (``label_join_slots``): one launch tests the
           endpoints, reads the two label rows of each pair and joins them
           (its plain version on a CPU index)
  "torch"  its plain version: ``endpoint_ok`` and ``slot_rows`` gather the
           [Q, W] slabs, ``label_join_packed_ref`` joins them

``backend=None`` resolves by the labels' device: "cuda" on a CUDA index,
"torch" on a CPU index. JAX serves with its jnp reference by default
(``freshness.reach_session(join_backend="jnp")``); the port's default is
the kernel, so that no plain version runs on the path when a card is
present.

Answers mirror ``core.bfs.multi_bfs``: an absent (slot < 0) or dead
endpoint is decided unreachable; a nonempty intersection is a 2-hop
witness, exact unconditionally; an empty one is exact only for a
``complete`` index, else ``decided=False``. The answers hold at the index
epoch: callers validate it first (``freshness.index_fresh``).
"""
from __future__ import annotations

import torch

from repro_torch.core.bfs import _as_slots
from repro_torch.core.graph import unpack_bits
from repro_torch.kernels.label_join import ops as _kernels
from repro_torch.kernels.label_join import ref as _plain

JOIN_BACKENDS = ("cuda", "torch")


def default_join_backend(device) -> str:
    """"cuda" for an index on the card, "torch" elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _join(index, src, dst, backend: str):
    """(hits, hub, src_ok, dst_ok) of the pairs."""
    if backend not in JOIN_BACKENDS:
        raise ValueError(f"unknown label_join backend {backend!r}")
    # looked up at call time, like core.bfs's step functions
    fn = {"cuda": _kernels.label_join_slots,
          "torch": _plain.label_join_slots_ref}[backend]
    return fn(index.out_label, index.in_label, index.alive, src, dst)


def query_reach(index, src_slots, dst_slots, *, backend: str | None = None):
    """Batched reachability probe: int32[Q] slot ids (-1 = absent) ->
    (reach bool[Q], decided bool[Q], hub int32[Q]). ``reach[q]`` equals
    ``multi_bfs(...).found[q]`` wherever ``decided[q]``; ``hub[q]`` is the
    canonical witness as an index into ``index.landmarks`` (-1 if none)."""
    if backend is None:
        backend = default_join_backend(index.alive.device)
    src = _as_slots(src_slots, index.alive.device)
    dst = _as_slots(dst_slots, index.alive.device)
    hits, hub, sok, dok = _join(index, src, dst, backend)
    hit = hits > 0
    # hit | ~sok | ~dok | complete; on bools ``ok <= hit`` is hit | ~ok in
    # one launch (a Python scalar in ``where`` would cost a fill)
    decided = torch.ones_like(hit) if index.complete else (sok & dok) <= hit
    return hit, decided, hub


def reach_sets(index, src_slots):
    """Full reachable sets: (sets bool[Q, V], decided bool[Q]) from one
    [Q, L] @ [L, V] product (0/1 operands, sums <= L: exact in float32).
    Rows are exact where decided (complete index, or an absent or dead
    source, whose set is empty)."""
    src = _as_slots(src_slots, index.alive.device)
    sok = _plain.endpoint_ok(index.alive, src)
    a = unpack_bits(_plain.slot_rows(index.out_label, src, sok),
                    index.num_landmarks).to(torch.float32)
    sets = (a @ index.in_label_bits.T.to(torch.float32)) > 0
    sets &= index.alive[None, :]
    return sets, ~sok | index.complete


def reach_counts(index, src_slots):
    """|reachable set| per source, the index-served form of
    ``core.bfs.reachable_count``: (counts int32[Q], decided bool[Q])."""
    sets, decided = reach_sets(index, src_slots)
    return sets.sum(1, dtype=torch.int32), decided
