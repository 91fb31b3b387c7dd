"""Plain version of the device serial correction pass: the host pass.

``_SerialPass`` keeps the slot table (vkey, valive, vver, ecnt) on the host
for the batch, where each lane's lookups are numpy scans, and applies each
lane's adjacency writes to the state's tensors as single-word or
single-row/column updates: an AddVertex scrub touches one row and one
column word of each mirror, never a whole [V, W] matrix. It is the
specification of ``core.ops.apply_ops``, the single-op API's engine, the
fast engine's correction pass on CPU states, and the base of the sharded
engine's pass (``core.partition._ShardedSerialPass``).

``serial_pass_ref`` is the kernel's contract, on any device: the six state
arrays (vkey int32[V], valive bool[V], vver int32[V], ecnt int32[V],
adj_packed and adj_in_packed int32[V, W]) are written in place with the
``mask``-selected lanes of the batch (opcode, key1, key2, expect int32[B]),
in lane order, and each selected lane's result code is written into
``res`` int32[B]; the other entries of ``res`` are left as they are.
Returns ``res``.
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
    unpack_bits,
)


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
                   pass_cls=_SerialPass):
    """Apply the selected ``lanes`` (ascending) of ``ops`` to ``st`` in
    place, in lane order; unselected lanes keep their ``res`` entry, and
    ``res`` is written in place and returned. This is both the reference
    engine (all lanes) and the host correction pass (the conflicting
    lanes). ``pass_cls`` is the pass class (the sharded engine brings its
    own)."""
    host = np.stack([t.cpu().numpy() for t in ops]).astype(np.int64)
    sp = pass_cls(st)
    for i in lanes:
        res[i] = sp.apply_one(*(int(x) for x in host[:, i]))
    sp.finish()
    return res


def serial_pass_ref(vkey, valive, vver, ecnt, adj_packed, adj_in_packed,
                    opcode, key1, key2, expect, mask, res):
    lanes = torch.nonzero(mask).flatten().tolist()
    if lanes:
        codes = res.cpu()  # res itself on the CPU: the codes land in place
        _serial_masked(GraphState(vkey, valive, vver, ecnt, adj_packed,
                                  adj_in_packed),
                       OpBatch(opcode, key1, key2, expect), lanes,
                       codes.numpy())
        if codes is not res:
            res.copy_(codes)
    return res
