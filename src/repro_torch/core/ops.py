"""Batched, linearizable graph mutations, in PyTorch.

The port of ``repro.core.ops``. A batch of B ops from B logical actors is
applied in one call; lane order is the linearization order.

``apply_ops``       the sequential specification: lanes applied one by one
                    in lane order.
``apply_ops_fast``  the disjoint-access-parallel engine: lanes whose keys
                    collide with no other lane are applied in one vectorized
                    pass, the rest in lane order by the serial correction
                    pass; an allocation schedule that would exhaust the free
                    slots sends every lane through the serial pass.
``apply_ops_fast_`` the same engine writing into its input state (torch's
                    trailing underscore): the entry of a store that one
                    owner holds outright (a bare ``GraphCoServer``).

All are bit-identical to the JAX engines: result codes, slot placement,
``ecnt``, ``vver`` and both packed mirrors.

``apply_ops`` and ``apply_ops_fast`` are functional (callers keep old
states), so each batch copies the state ONCE and mutates the copy in
place. ``apply_ops_fast_`` skips that copy unless the batch's schedule
overflows the free slots or a lane names a negative key: those batches can
answer R_TABLE_FULL, and a caller that grows and replays needs the
pre-batch state, so they copy and leave the input untouched. On a CUDA
state the fast engine's serial pass is one launch of
``kernels/serial_pass``: the mask, the state and the result codes stay on
the device. The host pass
(``kernels/serial_pass/ref.py``: ``_SerialPass`` through ``_serial_masked``)
is ``apply_ops``, the single-op API, the fast engine's pass on CPU states
and the kernel's plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import (
    EMPTY_KEY,
    OP_ADD_E,
    OP_ADD_V,
    OP_CON_E,
    OP_CON_V,
    OP_NOP,
    OP_REM_E,
    OP_REM_V,
    R_CAS_FAIL,
    R_EDGE_ADDED,
    R_EDGE_NOT_PRESENT,
    R_EDGE_PRESENT,
    R_EDGE_REMOVED,
    R_FALSE,
    R_TRUE,
    R_VERTEX_NOT_PRESENT,
    WORD_BITS,
    GraphState,
    OpBatch,
    bit_mask,
    find_slot,
    get_bit,
    pack_bits,
    popcount,
    unpack_bits,
    wrap_int32,
)
from repro_torch.kernels.serial_pass.ops import serial_pass
from repro_torch.kernels.serial_pass.ref import _SerialPass, _serial_masked
from repro_torch.obs import trace as _trace


def _copy(state: GraphState) -> GraphState:
    """The one copy a batch makes before mutating in place."""
    with _trace.span("ops.copy"):
        return GraphState(*(t.clone() for t in state))


def apply_ops(state: GraphState, ops: OpBatch):
    """Apply a batch with exact lane-order linearization (reference engine).
    Returns (new state, result codes int32[B])."""
    st = _copy(state)
    with _trace.span("ops.serial_pass", lanes=ops.lanes, engine="host"):
        res = _serial_masked(st, ops, range(ops.lanes),
                             np.full((ops.lanes,), R_FALSE, np.int32))
        return st, torch.from_numpy(res).to(state.device)


# ----------------------------------------------------------------------------
# Fast engine: disjoint-access parallelism
# ----------------------------------------------------------------------------
def _lane_conflicts(ops: OpBatch) -> torch.Tensor:
    """True for lanes that must take the serial correction pass: lanes
    sharing a key with another lane (sort-based), every RemoveVertex, CAS
    edge lanes when the batch has a RemoveVertex, and lanes naming a
    negative key (see the JAX ``_lane_conflicts``)."""
    b = ops.lanes
    dev = ops.opcode.device
    opc = ops.opcode
    is_edge = (opc == OP_ADD_E) | (opc == OP_REM_E) | (opc == OP_CON_E)
    is_vert = (opc == OP_ADD_V) | (opc == OP_REM_V) | (opc == OP_CON_V)
    neg = torch.full_like(ops.key1, -1)
    k1 = torch.where(is_edge | is_vert, ops.key1, neg)
    k2 = torch.where(is_edge, ops.key2, neg)
    keys = torch.cat([k1, k2])
    lane = torch.arange(b, device=dev).repeat(2)
    order = torch.argsort(keys, stable=True)
    sk, sl = keys[order], lane[order]
    same = (sk[1:] == sk[:-1]) & (sk[1:] >= 0)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    dup = torch.cat([no, same]) | torch.cat([same, no])
    conflict = torch.zeros(b, dtype=torch.int32, device=dev)
    conflict = conflict.index_add_(0, sl, dup.to(torch.int32)) > 0
    conflict |= opc == OP_REM_V
    is_cas_edge = ((opc == OP_ADD_E) | (opc == OP_REM_E)) & (ops.expect >= 0)
    conflict |= is_cas_edge & (opc == OP_REM_V).any()
    return conflict | _negative_lanes(ops)


def _negative_lanes(ops: OpBatch) -> torch.Tensor:
    """True for lanes naming a negative key: a vertex op's key1, an edge
    op's key1 or key2."""
    opc = ops.opcode
    is_edge = (opc == OP_ADD_E) | (opc == OP_REM_E) | (opc == OP_CON_E)
    is_vert = (opc == OP_ADD_V) | (opc == OP_REM_V) | (opc == OP_CON_V)
    return ((is_vert & (ops.key1 < 0))
            | (is_edge & ((ops.key1 < 0) | (ops.key2 < 0))))


def _alive_now(state: GraphState, keys: torch.Tensor) -> torch.Tensor:
    """Alive-slot existence per key [B], without the key >= 0 guard."""
    return ((state.vkey[None, :] == keys[:, None])
            & state.valive[None, :]).any(1)


def _alloc_schedule(state: GraphState, ops: OpBatch):
    """Lane-order-faithful AddVertex allocation schedule.

    Returns (wants bool[B], slot int64[B], overflow 0-d bool): ``wants[i]``
    is an AddVertex that allocates under serial execution, ``slot[i]`` the
    free slot it takes (``capacity`` when parked), ``overflow`` whether the
    schedule needs more slots than are free."""
    b = ops.lanes
    dev = ops.opcode.device
    is_addv = ops.opcode == OP_ADD_V
    is_vmut = is_addv | (ops.opcode == OP_REM_V)
    alive0 = _alive_now(state, ops.key1)
    lane = torch.arange(b, device=dev)
    prior = ((ops.key1[:, None] == ops.key1[None, :]) & is_vmut[None, :]
             & (lane[None, :] < lane[:, None]))
    has_prior = prior.any(1)
    # the last prior vertex-mutating lane on the same key decides liveness
    last_j = torch.where(prior, lane[None, :], -1).amax(1).clamp(min=0)
    alive_at_turn = torch.where(has_prior, is_addv[last_j], alive0)
    wants = is_addv & ~alive_at_turn
    rank = torch.cumsum(wants.to(torch.int64), 0) - 1
    free_cum = torch.cumsum((state.vkey == EMPTY_KEY).to(torch.int64), 0)
    # rank r takes the (r+1)-th free slot: serial argmax-free order
    slot = torch.searchsorted(free_cum, rank + 1, side="left")
    slot = torch.where(wants, slot, state.capacity)
    overflow = wants.sum() > free_cum[-1]
    return wants, slot, overflow


def _find_slots_masked(state: GraphState, keys: torch.Tensor) -> torch.Tensor:
    hit = ((state.vkey[None, :] == keys[:, None]) & state.valive[None, :]
           & (keys[:, None] >= 0))
    idx = hit.to(torch.int8).argmax(1)
    return torch.where(hit.any(1), idx, -1)


def _words_mask(cols: torch.Tensor):
    """Distinct word indices of ``cols`` and, per word, the OR of their
    bits (cols must be distinct)."""
    words, inv = torch.unique(cols // WORD_BITS, return_inverse=True)
    bits = torch.zeros(words.shape, dtype=torch.int64, device=cols.device)
    bits.index_add_(0, inv, 1 << (cols % WORD_BITS))
    return words, wrap_int32(bits)


def _apply_clean_vectorized(st: GraphState, ops: OpBatch,
                            active: torch.Tensor, wants: torch.Tensor,
                            slot: torch.Tensor) -> torch.Tensor:
    """One vectorized pass applying all ``active`` lanes to ``st`` in place.

    Preconditions (as in JAX): active lanes name pairwise-disjoint keys,
    RemoveVertex lanes are never active, and AddVertex allocation follows
    the non-overflowing ``_alloc_schedule``. Reads that JAX takes from the
    input state (slots, current bits, CAS ecnt) happen before any write."""
    b = ops.lanes
    dev = st.vkey.device
    s1 = _find_slots_masked(st, ops.key1)
    s2 = _find_slots_masked(st, ops.key2)
    opc = ops.opcode
    is_addv = active & (opc == OP_ADD_V)
    is_conv = active & (opc == OP_CON_V)
    is_adde = active & (opc == OP_ADD_E)
    is_reme = active & (opc == OP_REM_E)
    is_cone = active & (opc == OP_CON_E)

    both = (s1 >= 0) & (s2 >= 0)
    r1, r2 = s1.clamp(min=0), s2.clamp(min=0)
    cur = get_bit(st.adj_packed, r1, r2)
    cas_ok = (ops.expect < 0) | (st.ecnt[r1] == ops.expect)

    def code(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    res = torch.full((b,), R_FALSE, dtype=torch.int32, device=dev)

    # --- AddVertex: scheduled free-slot allocation, then the scrub ----------
    alloc = slot[is_addv & wants]
    if alloc.numel():
        st.vkey[alloc] = ops.key1[is_addv & wants]
        st.valive[alloc] = True
        st.vver[alloc] += 1
        st.ecnt[alloc] = 0
        words, bits = _words_mask(alloc)
        for adj in (st.adj_packed, st.adj_in_packed):
            adj[alloc] = 0
            adj[:, words] &= ~bits
    res = torch.where(is_addv, torch.where(wants, code(R_TRUE),
                                           code(R_FALSE)), res)

    # --- ContainsVertex -------------------------------------------------------
    res = torch.where(is_conv, torch.where(s1 >= 0, code(R_TRUE),
                                           code(R_FALSE)), res)

    # --- Edge ops: single-word RMWs on distinct rows of each mirror ----------
    do_add = is_adde & both & cas_ok & ~cur
    do_rem = is_reme & both & cas_ok & cur
    fire = do_add | do_rem
    if fire.any():
        add, rows, cols = do_add[fire], r1[fire], r2[fire]
        for adj, r, c in ((st.adj_packed, rows, cols),
                          (st.adj_in_packed, cols, rows)):
            w, m = c // WORD_BITS, bit_mask(c)
            curw = adj[r, w]
            adj[r, w] = torch.where(add, curw | m, curw & ~m)
        st.ecnt[rows] += 1

    vnp = code(R_VERTEX_NOT_PRESENT)
    cas = code(R_CAS_FAIL)
    res = torch.where(is_adde, torch.where(both, torch.where(
        cas_ok, torch.where(cur, code(R_EDGE_PRESENT), code(R_EDGE_ADDED)),
        cas), vnp), res)
    res = torch.where(is_reme, torch.where(both, torch.where(
        cas_ok, torch.where(cur, code(R_EDGE_REMOVED),
                            code(R_EDGE_NOT_PRESENT)), cas), vnp), res)
    res = torch.where(is_cone, torch.where(
        both, torch.where(cur, code(R_EDGE_PRESENT),
                          code(R_EDGE_NOT_PRESENT)), vnp), res)
    return res


def apply_ops_fast(state: GraphState, ops: OpBatch):
    """Disjoint-access-parallel batch application, bit-identical to
    ``apply_ops``. Linearization order: all conflict-free lanes first (they
    commute with every lane), then the conflicting lanes in lane order.
    Returns (new state, result codes int32[B]); ``state`` is untouched."""
    return _apply_fast(state, ops, in_place=False)


def apply_ops_fast_(state: GraphState, ops: OpBatch):
    """``apply_ops_fast`` writing into ``state`` itself, for a caller that
    holds the store outright. A batch whose allocation schedule overflows
    the free slots, or with a lane naming a negative key, is applied to a
    copy as ``apply_ops_fast`` does and leaves ``state`` untouched: only
    such a batch can answer R_TABLE_FULL. Returns (state, codes); the
    returned state ``is`` the input exactly when the batch went in place."""
    return _apply_fast(state, ops, in_place=True)


def _apply_fast(state: GraphState, ops: OpBatch, in_place: bool):
    if ops.lanes == 0:
        return (state if in_place else _copy(state)), ops.opcode.clone()
    with _trace.span("ops.apply", lanes=ops.lanes) as sp:
        with _trace.span("ops.schedule"):
            conflict = _lane_conflicts(ops)
            clean = ~conflict & (ops.opcode != OP_NOP)
            wants, slot, overflow = _alloc_schedule(state, ops)
            # repro-torch-lint: allow(trace-purity) — one read a batch: the overflow flag picks the serial lanes, they are counted, and with a negative key it keeps the input
            replay, lanes, negative = torch.stack([
                overflow.long(), conflict.sum(),
                _negative_lanes(ops).any().long()]).tolist()
        # the schedule and the clean pass read before they write, so the
        # batch may land in the input unless it can answer R_TABLE_FULL
        in_place = in_place and not replay and not negative
        st = state if in_place else _copy(state)
        if replay:
            # capacity exhaustion couples lanes across keys: every lane
            # takes the serial pass
            serial, lanes = torch.ones_like(conflict), ops.lanes
            res = torch.full((ops.lanes,), R_FALSE, dtype=torch.int32,
                             device=state.device)
        else:
            serial = conflict
            with _trace.span("ops.clean_pass"):
                res = _apply_clean_vectorized(st, ops, clean, wants, slot)
        # the serial lanes in lane order: one launch on the card, the host
        # pass on the CPU
        with _trace.span("ops.serial_pass", lanes=lanes,
                         engine="device" if st.vkey.is_cuda else "host"):
            if lanes:
                serial_pass(*st, *ops, serial, res)
        sp.set(serial_lanes=lanes, replay=replay > 0, in_place=in_place)
        return st, res


# ----------------------------------------------------------------------------
# Single-op API and the undirected extension
# ----------------------------------------------------------------------------
def _single(state: GraphState, fn):
    st = _copy(state)
    sp = _SerialPass(st)
    r = fn(sp)
    sp.finish()
    return st, torch.tensor(r, dtype=torch.int32, device=state.device)


def add_vertex(state: GraphState, k):
    return _single(state, lambda sp: sp.add_vertex(int(k)))


def remove_vertex(state: GraphState, k):
    return _single(state, lambda sp: sp.remove_vertex(int(k)))


def add_edge(state: GraphState, k, l):
    return _single(state, lambda sp: sp.edge_op(int(k), int(l), -1, True))


def remove_edge(state: GraphState, k, l):
    return _single(state, lambda sp: sp.edge_op(int(k), int(l), -1, False))


def add_edge_undirected(state: GraphState, k, l):
    """Both directions at one linearization point; both endpoint rows take
    the FAA."""
    return _single(state, lambda sp: sp.edge_op(int(k), int(l), -1, True,
                                                undirected=True))


def remove_edge_undirected(state: GraphState, k, l):
    return _single(state, lambda sp: sp.edge_op(int(k), int(l), -1, False,
                                                undirected=True))


# ----------------------------------------------------------------------------
# Wait-free neighborhood queries
# ----------------------------------------------------------------------------
def neighbors(state: GraphState, k):
    """Out-neighbor keys of v(k): (count, keys int32[V] padded with -1)."""
    slot = find_slot(state, int(k))
    row = unpack_bits(state.adj_packed[slot.clamp(min=0)], state.capacity)
    live = row & state.valive & (slot >= 0)
    n = live.sum().to(torch.int32)
    order = torch.argsort((~live).to(torch.int8), stable=True)
    keys = torch.where(live[order], state.vkey[order], -1)
    return n, keys


def degree(state: GraphState, k):
    """(out_degree, in_degree) of v(k); (-1, -1) if absent. Both are one
    popcount over the slot's live row words."""
    slot = find_slot(state, int(k))
    s = slot.clamp(min=0)
    aw = state.alive_words
    out_d = popcount(state.adj_packed[s] & aw).sum().to(torch.int32)
    in_d = torch.where(state.valive[s],
                       popcount(state.adj_in_packed[s] & aw).sum(), 0)
    ok = slot >= 0
    return (torch.where(ok, out_d, -1).to(torch.int32),
            torch.where(ok, in_d, -1).to(torch.int32))


# ----------------------------------------------------------------------------
# Physical removal: the helping / compaction analogue
# ----------------------------------------------------------------------------
def compact(state: GraphState) -> GraphState:
    """Physically remove logically deleted vertices: free their slots and
    clear their rows and columns in both mirrors; versions are kept so
    outstanding double collects still see the change."""
    dead = ~state.valive & (state.vkey != EMPTY_KEY)
    keep = ~dead
    keep_words = pack_bits(keep)[None, :]
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    return GraphState(
        torch.where(dead, EMPTY_KEY, state.vkey), state.valive, state.vver,
        state.ecnt,
        torch.where(keep[:, None], state.adj_packed & keep_words, zero),
        torch.where(keep[:, None], state.adj_in_packed & keep_words, zero))
