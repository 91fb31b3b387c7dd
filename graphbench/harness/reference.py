"""The plain reference: a directed graph store on keys, in Python and
NumPy, written from the paper's sequential specification.

It imports nothing of the program. It is handed the loaded edge list and
the same op batches as the program, applies each batch's lanes one by one
in lane order (the linearization order the store guarantees), and answers
reachability with a breadth-first search of its own over the live edges.
Result codes are the store's published integers (its wire format).

Sequential specification, per lane:
  AddV k   TRUE, or FALSE if k is alive; TABLE FULL if no slot is free
           (the store has ``capacity`` slots; a removed vertex keeps its
           slot until the store is compacted)
  RemV k   TRUE and every edge at k removed, or FALSE if k is not alive
  ConV k   TRUE if k is alive, else FALSE
  AddE k l VERTEX NOT PRESENT unless both are alive; EDGE PRESENT, or
           EDGE ADDED
  RemE k l VERTEX NOT PRESENT; EDGE NOT PRESENT, or EDGE REMOVED
  ConE k l VERTEX NOT PRESENT; EDGE PRESENT or EDGE NOT PRESENT
A vertex added again starts with no edges. GetPath(k, l): found iff l is
reachable from k over live edges (both ends alive); the path is a
shortest one.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

R_FALSE, R_TRUE = 0, 1
R_VERTEX_NOT_PRESENT, R_EDGE_NOT_PRESENT, R_EDGE_PRESENT = 2, 3, 4
R_EDGE_ADDED, R_EDGE_REMOVED, R_TABLE_FULL = 5, 6, 7
ADD_V, REM_V, CON_V, ADD_E, REM_E, CON_E = 1, 2, 3, 4, 5, 6


class ReferenceStore:
    """Keys 0..n_keys-1; the first ``n_loaded`` alive with the loaded
    edges (``u``, ``v``: distinct, sorted by (u, v)), and the keys
    ``also`` alive with none; searches run on ``device``."""

    def __init__(self, n_loaded: int, n_keys: int, capacity: int, u, v,
                 also=(), device="cpu"):
        self.nk = int(n_keys)
        self.device = device
        self.capacity = int(capacity)
        self.alive = bytearray(self.nk)
        self.alive[:n_loaded] = b"\x01" * n_loaded
        for k in also:
            self.alive[int(k)] = 1
        self.occupied = int(sum(self.alive))
        self.base_u = np.asarray(u, np.int64)
        self.base_v = np.asarray(v, np.int64)
        base_ids = self.base_u * self.nk + self.base_v   # sorted
        self.removed = set()          # loaded edges removed since
        self.extra = set()            # edges present that were not loaded
        self.extra_out = defaultdict(set)
        self.extra_in = defaultdict(set)
        # loaded edges by source (sorted) and by target, for RemV and BFS
        self.out_start = np.searchsorted(self.base_u, np.arange(self.nk + 1))
        self.in_order = np.argsort(self.base_v, kind="stable")
        self.in_start = np.searchsorted(self.base_v[self.in_order],
                                        np.arange(self.nk + 1))
        self.base_ids = base_ids
        self._edges_dev = None

    # -- edges -------------------------------------------------------------
    def loaded(self, e: int) -> bool:
        """Whether edge id ``e`` was loaded."""
        ids = self.base_ids
        i = int(np.searchsorted(ids, e))
        return i < len(ids) and int(ids[i]) == e

    def present(self, k: int, l: int) -> bool:
        e = k * self.nk + l
        if e in self.extra:
            return True
        return e not in self.removed and self.loaded(e)

    def _add(self, k: int, l: int) -> None:
        e = k * self.nk + l
        if self.loaded(e):
            self.removed.discard(e)
        else:
            self.extra.add(e)
            self.extra_out[k].add(l)
            self.extra_in[l].add(k)

    def _remove(self, k: int, l: int) -> None:
        e = k * self.nk + l
        if e in self.extra:
            self.extra.discard(e)
            self.extra_out[k].discard(l)
            self.extra_in[l].discard(k)
        else:
            self.removed.add(e)

    def _incident(self, k: int):
        outs = self.base_v[self.out_start[k]:self.out_start[k + 1]].tolist()
        ins = self.base_u[self.in_order[self.in_start[k]:
                                        self.in_start[k + 1]]].tolist()
        return ([(k, w) for w in outs + list(self.extra_out[k])]
                + [(w, k) for w in ins + list(self.extra_in[k])])

    # -- one lane ----------------------------------------------------------
    def apply(self, op: int, k: int, l: int) -> int:
        alive = self.alive
        if op == CON_V:
            return R_TRUE if 0 <= k < self.nk and alive[k] else R_FALSE
        if op == ADD_V:
            if alive[k]:
                return R_FALSE
            if self.occupied >= self.capacity:
                return R_TABLE_FULL
            alive[k] = 1
            self.occupied += 1
            return R_TRUE
        if op == REM_V:
            if not alive[k]:
                return R_FALSE
            for a, b in self._incident(k):
                if self.present(a, b):
                    self._remove(a, b)
            alive[k] = 0
            return R_TRUE
        if op in (ADD_E, REM_E, CON_E):
            if not (alive[k] and alive[l]):
                return R_VERTEX_NOT_PRESENT
            here = self.present(k, l)
            if op == CON_E:
                return R_EDGE_PRESENT if here else R_EDGE_NOT_PRESENT
            if op == ADD_E:
                if here:
                    return R_EDGE_PRESENT
                self._add(k, l)
                return R_EDGE_ADDED
            if not here:
                return R_EDGE_NOT_PRESENT
            self._remove(k, l)
            return R_EDGE_REMOVED
        return R_FALSE

    def apply_batch(self, ops: np.ndarray) -> np.ndarray:
        """Result codes of one batch (int64[B, 3]: opcode, key1, key2),
        lane by lane."""
        apply = self.apply
        return np.array([apply(o, a, b) for o, a, b in ops.tolist()],
                        np.int32)

    def compact(self) -> None:
        """The store frees the slots of removed vertices."""
        self.occupied = int(sum(self.alive))

    # -- reachability ------------------------------------------------------
    def live_edges(self):
        """(u, v) int64 arrays of every live edge, sorted by (u, v)."""
        ids = self.base_ids
        if self.removed:
            ids = ids[~np.isin(ids, np.fromiter(self.removed, np.int64))]
        if self.extra:
            ids = np.sort(np.concatenate(
                [ids, np.fromiter(self.extra, np.int64)]))
        u, v = ids // self.nk, ids % self.nk
        alive = np.frombuffer(bytes(self.alive), np.uint8).astype(bool)
        keep = alive[u] & alive[v]
        return u[keep], v[keep]

    def _live_dev(self):
        """(alive bool[n_keys + 1], u, v) of the live edges, as tensors on
        the search's device."""
        import torch

        dev = self.device
        if self._edges_dev is None:
            self._edges_dev = tuple(torch.from_numpy(a).to(dev) for a in
                                    (self.base_u, self.base_v, self.base_ids))
        bu, bv, bids = self._edges_dev
        alive = torch.zeros(self.nk + 1, dtype=torch.bool, device=dev)
        alive[:self.nk] = torch.from_numpy(
            np.frombuffer(bytes(self.alive), np.uint8) != 0).to(dev)
        keep = alive[bu] & alive[bv]
        if self.removed:
            gone = torch.from_numpy(np.fromiter(self.removed, np.int64))
            keep &= ~torch.isin(bids, gone.to(dev))
        ex = torch.from_numpy(np.fromiter(self.extra, np.int64,
                                          len(self.extra))).to(dev)
        eu, ev = ex // self.nk, ex % self.nk
        ek = alive[eu] & alive[ev]
        return (alive, torch.cat([bu[keep], eu[ek]]),
                torch.cat([bv[keep], ev[ek]]))

    def _levels(self, chunk: np.ndarray, max_depth: int | None):
        """The BFS of (source, target) pairs at once, one column a query,
        level by level over the live edges: (hops per pair, -1 when
        unreachable; bool[n_keys + 1, Q] of the keys first reached at each
        level)."""
        import torch

        alive, eu, ev = self._live_dev()
        dev, q = alive.device, len(chunk)
        src = torch.from_numpy(chunk[:, 0]).to(dev)
        dst = torch.from_numpy(chunk[:, 1]).to(dev)
        qi = torch.arange(q, device=dev)
        frontier = torch.zeros((self.nk + 1, q), dtype=torch.bool, device=dev)
        frontier[src, qi] = alive[src]
        visited = frontier.clone()
        levels = [frontier]
        dist = torch.full((q,), -1, dtype=torch.int64, device=dev)
        while True:
            hit = visited[dst, qi] & (dist < 0)
            dist[hit] = len(levels) - 1
            if (bool((dist >= 0).all()) or not bool(frontier.any())
                    or (max_depth is not None and len(levels) > max_depth)):
                break
            act = frontier.any(1)[eu]
            a, b = eu[act], ev[act]
            reach = torch.zeros((self.nk + 1, q), dtype=torch.int32,
                                device=dev)
            reach.index_add_(0, b, frontier[a].to(torch.int32))
            new = (reach > 0) & ~visited & alive[:, None]
            visited |= new
            frontier = new
            levels.append(new)
        return dist.cpu().numpy(), levels

    def distances(self, pairs: np.ndarray) -> np.ndarray:
        """Hops of a shortest path per (source, target) pair, -1 when the
        target is unreachable."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        return np.concatenate(
            [self._levels(pairs[q0:q0 + 64], None)[0]
             for q0 in range(0, len(pairs), 64)] or [np.zeros(0, np.int64)])

    def in_neighbours(self, k: int) -> list:
        """Keys with a live edge into ``k``."""
        ins = self.base_u[self.in_order[self.in_start[k]:
                                        self.in_start[k + 1]]].tolist()
        return [w for w in ins + list(self.extra_in[k])
                if self.alive[w] and self.present(w, k)]

    def paths(self, pairs, max_depth: int | None = None) -> list:
        """[(found, keys of a shortest path)] per pair, walked back from
        each target through the levels, the smallest key first;
        ``max_depth`` stops the search after that many levels."""
        pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
        out = []
        for q0 in range(0, len(pairs), 64):
            chunk = pairs[q0:q0 + 64]
            dist, levels = self._levels(chunk, max_depth)
            levels = [lv.cpu().numpy() for lv in levels]
            for qi, (d, (k, l)) in enumerate(zip(dist.tolist(),
                                                 chunk.tolist())):
                if d < 0:
                    out.append((False, []))
                    continue
                path = [l]
                for lv in range(d - 1, -1, -1):
                    path.append(min(w for w in self.in_neighbours(path[-1])
                                    if levels[lv][w, qi]))
                out.append((True, path[::-1]))
        return out
