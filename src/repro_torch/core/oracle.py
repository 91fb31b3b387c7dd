"""Sequential Python oracle — the port's own executable sequential
specification (a copy of the JAX package's, so the port imports nothing of
it).

A concurrent (batched) execution is linearizable iff its results and final
state equal the oracle's when ops are replayed in the claimed linearization
order (lane order for ``apply_ops``).
"""
from __future__ import annotations

from collections import deque

from repro_torch.core.graph import (
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
)


class GraphOracle:
    """Reference implementation over Python dict/set with identical semantics
    (result codes, ecnt evolution, slot-occupancy capacity accounting)."""

    def __init__(self, capacity: int = 1 << 30):
        self.capacity = capacity
        self.ecnt: dict[int, int] = {}     # alive vertices -> ecnt
        self.edges: set[tuple[int, int]] = set()
        self.occupied = 0                  # alive + dead-uncompacted slots

    # -- vertex ops ----------------------------------------------------------
    def add_vertex(self, k: int) -> int:
        if k in self.ecnt:
            return R_FALSE
        if self.occupied >= self.capacity:
            return R_TABLE_FULL
        self.ecnt[k] = 0
        self.occupied += 1
        return R_TRUE

    def remove_vertex(self, k: int) -> int:
        if k not in self.ecnt:
            return R_FALSE
        # bump in-edge sources (incl. self-loop source) — see ops._remove_vertex
        for (u, w) in list(self.edges):
            if w == k and u in self.ecnt:
                self.ecnt[u] += 1
        del self.ecnt[k]
        self.edges = {(u, w) for (u, w) in self.edges if u != k and w != k}
        return R_TRUE

    def contains_vertex(self, k: int) -> int:
        return R_TRUE if k in self.ecnt else R_FALSE

    # -- edge ops --------------------------------------------------------------
    def add_edge(self, k: int, l: int, expect: int = -1) -> int:
        if k not in self.ecnt or l not in self.ecnt:
            return R_VERTEX_NOT_PRESENT
        if expect >= 0 and self.ecnt[k] != expect:
            return R_CAS_FAIL
        if (k, l) in self.edges:
            return R_EDGE_PRESENT
        self.edges.add((k, l))
        self.ecnt[k] += 1
        return R_EDGE_ADDED

    def remove_edge(self, k: int, l: int, expect: int = -1) -> int:
        if k not in self.ecnt or l not in self.ecnt:
            return R_VERTEX_NOT_PRESENT
        if expect >= 0 and self.ecnt[k] != expect:
            return R_CAS_FAIL
        if (k, l) not in self.edges:
            return R_EDGE_NOT_PRESENT
        self.edges.discard((k, l))
        self.ecnt[k] += 1
        return R_EDGE_REMOVED

    def contains_edge(self, k: int, l: int) -> int:
        if k not in self.ecnt or l not in self.ecnt:
            return R_VERTEX_NOT_PRESENT
        return R_EDGE_PRESENT if (k, l) in self.edges else R_EDGE_NOT_PRESENT

    def compact(self) -> None:
        self.occupied = len(self.ecnt)

    # -- batch replay -----------------------------------------------------------
    def apply(self, opcode: int, k1: int, k2: int, expect: int = -1) -> int:
        if opcode == OP_NOP:
            return R_FALSE
        if opcode == OP_ADD_V:
            return self.add_vertex(k1)
        if opcode == OP_REM_V:
            return self.remove_vertex(k1)
        if opcode == OP_CON_V:
            return self.contains_vertex(k1)
        if opcode == OP_ADD_E:
            return self.add_edge(k1, k2, expect)
        if opcode == OP_REM_E:
            return self.remove_edge(k1, k2, expect)
        if opcode == OP_CON_E:
            return self.contains_edge(k1, k2)
        raise ValueError(f"bad opcode {opcode}")

    def apply_batch(self, ops) -> list[int]:
        """ops: iterable of (opcode, k1, k2, expect)."""
        return [self.apply(*op) for op in ops]

    # -- queries ------------------------------------------------------------------
    def reachable(self, k: int, l: int) -> bool:
        if k not in self.ecnt or l not in self.ecnt:
            return False
        seen = {k}
        dq = deque([k])
        while dq:
            u = dq.popleft()
            if u == l:
                return True
            for (a, b) in self.edges:
                if a == u and b not in seen and b in self.ecnt:
                    seen.add(b)
                    dq.append(b)
        return False

    def shortest_path_len(self, k: int, l: int) -> int:
        """#vertices on a shortest path, 0 if unreachable."""
        if k not in self.ecnt or l not in self.ecnt:
            return 0
        dist = {k: 1}
        dq = deque([k])
        while dq:
            u = dq.popleft()
            if u == l:
                return dist[u]
            for (a, b) in self.edges:
                if a == u and b not in dist and b in self.ecnt:
                    dist[b] = dist[u] + 1
                    dq.append(b)
        return 0

    def is_valid_path(self, keys: list[int], k: int, l: int) -> bool:
        """Is ``keys`` a path k..l through current edges? (path-validity check)"""
        if not keys or keys[0] != k or keys[-1] != l:
            return False
        for a in keys:
            if a not in self.ecnt:
                return False
        return all((a, b) in self.edges for a, b in zip(keys, keys[1:]))

    # -- state comparison -----------------------------------------------------------
    def state_tuple(self):
        return (dict(self.ecnt), set(self.edges))
