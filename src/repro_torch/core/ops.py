"""Batched, linearizable graph mutations, in PyTorch.

The port of ``repro.core.ops``. A batch of B ops from B logical actors is
applied in one call; lane order is the linearization order.

``apply_ops``       the sequential specification: lanes applied one by one
                    in lane order.
``apply_ops_fast``  the disjoint-access-parallel engine: lanes whose keys
                    collide with no other lane are applied in one vectorized
                    pass, the rest in lane order by the serial correction
                    pass; an allocation schedule that would exhaust the free
                    slots falls back to full serial replay.

Both are bit-identical to the JAX engines: result codes, slot placement,
``ecnt``, ``vver`` and both packed mirrors.

The engines are functional (callers keep old states), so each batch copies
the state ONCE and mutates the copy in place. The serial pass keeps the
slot table (vkey, valive, vver, ecnt) on the host for the batch, where each
lane's lookups are numpy scans, and applies each lane's adjacency writes to
the device copy as single-word or single-row/column updates: an AddVertex
scrub touches one row and one column word of each mirror, never a whole
[V, W] matrix.
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
    R_TABLE_FULL,
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


def _copy(state: GraphState) -> GraphState:
    """The one copy a batch makes before mutating in place."""
    return GraphState(*(t.clone() for t in state))


# ----------------------------------------------------------------------------
# Serial engine: the slot table on the host, adjacency writes on the device
# ----------------------------------------------------------------------------
class _SerialPass:
    """One lane-order pass over a state copy ``st`` that it mutates in
    place. The slot table lives in numpy for the pass and is written back
    by ``finish``."""

    def __init__(self, st: GraphState):
        self.st = st
        self.vkey = st.vkey.cpu().numpy().copy()
        self.valive = st.valive.cpu().numpy().copy()
        self.vver = st.vver.cpu().numpy().copy()
        self.ecnt = st.ecnt.cpu().numpy().copy()

    def finish(self) -> None:
        for dst, src in ((self.st.vkey, self.vkey),
                         (self.st.valive, self.valive),
                         (self.st.vver, self.vver),
                         (self.st.ecnt, self.ecnt)):
            dst.copy_(torch.from_numpy(src))

    # -- lookups ---------------------------------------------------------------
    def find(self, key: int) -> int:
        hit = (self.vkey == key) & self.valive
        return int(hit.argmax()) if hit.any() else -1

    def free_slot(self) -> int:
        free = self.vkey == EMPTY_KEY
        return int(free.argmax()) if free.any() else -1

    def bit(self, row: int, col: int) -> bool:
        word = int(self.st.adj_packed[row, col // WORD_BITS])
        return (word & bit_mask(col)) != 0

    def in_sources(self, slot: int) -> np.ndarray:
        """bool[V] on the host: the rows with an edge into ``slot`` (its
        in-adjacency row), liveness not applied."""
        return unpack_bits(self.st.adj_in_packed[slot],
                           len(self.vkey)).cpu().numpy()

    # -- adjacency writes (both mirrors, single words / one row + column) -----
    def set_edge(self, row: int, col: int, present: bool) -> None:
        for adj, r, c in ((self.st.adj_packed, row, col),
                          (self.st.adj_in_packed, col, row)):
            m = bit_mask(c)
            cell = adj[r, c // WORD_BITS]  # a view: the RMW is in place
            if present:
                cell.bitwise_or_(m)
            else:
                cell.bitwise_and_(~m)

    def scrub(self, slot: int) -> None:
        """Clear row ``slot`` and column bit ``slot`` of both mirrors (the
        scrub set is its own transpose, so both take the same clear)."""
        m = ~bit_mask(slot)
        for adj in (self.st.adj_packed, self.st.adj_in_packed):
            adj[slot].zero_()
            adj[:, slot // WORD_BITS].bitwise_and_(m)

    # -- single ops (the JAX ``_apply_one`` branches) ---------------------------
    def add_vertex(self, k: int) -> int:
        if self.find(k) >= 0:
            return R_FALSE
        tgt = self.free_slot()
        if tgt < 0:
            return R_TABLE_FULL
        self.vkey[tgt] = k
        self.valive[tgt] = True
        self.vver[tgt] += 1
        self.ecnt[tgt] = 0
        self.scrub(tgt)
        return R_TRUE

    def remove_vertex(self, k: int) -> int:
        tgt = self.find(k)
        if tgt < 0:
            return R_FALSE
        # every live in-edge source's ecnt moves (liveness read BEFORE the
        # mark, so a self-loop bumps the vertex's own ecnt too)
        in_src = self.in_sources(tgt) & self.valive
        self.valive[tgt] = False
        self.vver[tgt] += 1
        self.ecnt[tgt] += 1
        self.ecnt += in_src.astype(np.int32)
        return R_TRUE

    def edge_op(self, k: int, l: int, expect: int, add: bool,
                undirected: bool = False) -> int:
        rk, rl = self.find(k), self.find(l)
        if rk < 0 or rl < 0:
            return R_VERTEX_NOT_PRESENT
        if expect >= 0 and self.ecnt[rk] != expect:
            return R_CAS_FAIL
        present = self.bit(rk, rl)
        if add and present:
            return R_EDGE_PRESENT
        if not add and not present:
            return R_EDGE_NOT_PRESENT
        self.set_edge(rk, rl, add)
        self.ecnt[rk] += 1
        if undirected:
            self.set_edge(rl, rk, add)
            if rk != rl:
                self.ecnt[rl] += 1
        return R_EDGE_ADDED if add else R_EDGE_REMOVED

    def contains_edge(self, k: int, l: int) -> int:
        rk, rl = self.find(k), self.find(l)
        if rk < 0 or rl < 0:
            return R_VERTEX_NOT_PRESENT
        return R_EDGE_PRESENT if self.bit(rk, rl) else R_EDGE_NOT_PRESENT

    def apply_one(self, opcode: int, k1: int, k2: int, expect: int) -> int:
        # out-of-range opcodes clip to [NOP, HasE], as the JAX lax.switch does
        opcode = min(max(opcode, OP_NOP), OP_CON_E)
        if opcode == OP_ADD_V:
            return self.add_vertex(k1)
        if opcode == OP_REM_V:
            return self.remove_vertex(k1)
        if opcode == OP_CON_V:
            return R_TRUE if self.find(k1) >= 0 else R_FALSE
        if opcode in (OP_ADD_E, OP_REM_E):
            return self.edge_op(k1, k2, expect, add=opcode == OP_ADD_E)
        if opcode == OP_CON_E:
            return self.contains_edge(k1, k2)
        return R_FALSE


def _serial_masked(st: GraphState, ops: OpBatch, lanes, res: np.ndarray,
                   serial_pass=_SerialPass):
    """Apply the selected ``lanes`` (ascending) of ``ops`` to ``st`` in
    place, in lane order; unselected lanes keep their ``res`` entry. This
    is both the reference engine (all lanes) and the fast engine's
    correction pass (the conflicting lanes). ``serial_pass`` is the pass
    class (the sharded engine brings its own)."""
    # repro-torch-lint: allow(trace-purity) — the serial pass runs on the host: one copy of the batch
    host = np.stack([t.cpu().numpy() for t in ops]).astype(np.int64)
    sp = serial_pass(st)
    for i in lanes:
        res[i] = sp.apply_one(*(int(x) for x in host[:, i]))
    sp.finish()
    return res


def apply_ops(state: GraphState, ops: OpBatch):
    """Apply a batch with exact lane-order linearization (reference engine).
    Returns (new state, result codes int32[B])."""
    st = _copy(state)
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
    conflict |= is_vert & (ops.key1 < 0)
    conflict |= is_edge & ((ops.key1 < 0) | (ops.key2 < 0))
    return conflict


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
    commute with every lane), then the conflicting lanes in lane order."""
    if ops.lanes == 0:
        return _copy(state), ops.opcode.clone()
    conflict = _lane_conflicts(ops)
    clean = ~conflict & (ops.opcode != OP_NOP)
    wants, slot, overflow = _alloc_schedule(state, ops)
    # repro-torch-lint: allow(trace-purity) — capacity overflow picks the engine: one scalar a batch
    if bool(overflow):
        # capacity exhaustion couples lanes across keys: full serial replay
        return apply_ops(state, ops)
    st = _copy(state)
    res = _apply_clean_vectorized(st, ops, clean, wants, slot)
    # repro-torch-lint: allow(trace-purity) — the conflicting lanes and their results go to the serial pass
    lanes = torch.nonzero(conflict).flatten().tolist()
    if lanes:
        res_np = _serial_masked(st, ops, lanes, res.cpu().numpy())  # repro-torch-lint: allow(trace-purity) — the serial pass reads the results on the host
        res = torch.from_numpy(res_np).to(state.device)
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
