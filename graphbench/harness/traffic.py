"""The one traffic generator: a closed loop of rounds, read from a mix
file.

A mix file (``graphbench/traffic/<name>.json``) gives:

  submit    {"lanes": B, "every": k, "mix": {op: share %}} or null: every
            k-th round (rounds 0, k, 2k, ...) starts with one batch of B
            lanes whose op counts are the shares rounded by largest
            remainder, in a random lane order. Ops: AddV RemV ConV AddE
            RemE ConE (the paper's §5 order).
  clients   {"count": C, "lanes": L, "mix": {op: share %},
             "exclusive": {"every": k, "lanes": L2, "mix": {...}}}, in
            place of ``submit``: every round, clients c0 .. c(C-1) each
            send one batch of L lanes, drawn as a submit batch is; every
            k-th round client cC, the exclusive one, sends one batch of L2
            lanes after them (the batch that holds RemV, which the
            program admits alone). ``exclusive`` may be left out. The
            harness submits each batch as its client's, in client order,
            and pumps the server's admission until the round's batches
            have landed.
  getpath   {"queries": Q} or null: every round ends with one GetPath
            session of Q (source, target) pairs.
  churn_keys      C: AddV and RemV draw keys uniformly from the C keys
                  above the loaded ones, so loaded vertices are never
                  removed and the graph stays the loaded Kronecker graph.
  rem_e_lag_rounds  L: a RemE lane removes the oldest pair that an AddE
                  lane of a round at least L rounds earlier added (first
                  in, first out, over the batches of every client in the
                  order they are drawn), or a uniform pair of loaded keys
                  while none is due.

Every other key rule is fixed here: AddE draws uniform pairs of loaded
keys; ConV draws uniform keys, ConE uniform pairs, of the whole key range
(loaded and churn); GetPath sources are uniform over the loaded vertices
with out-degree >= 1 at set-up (Graph500's search keys), targets uniform
over the loaded keys. The stream depends on the seed alone, never on what
the program answers or how fast it runs.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

OPS = ("AddV", "RemV", "ConV", "AddE", "RemE", "ConE")
OPCODE = {"AddV": 1, "RemV": 2, "ConV": 3, "AddE": 4, "RemE": 5, "ConE": 6}


def lane_counts(lanes: int, mix: dict) -> np.ndarray:
    """Lanes of each op in ``OPS`` order: the shares of ``lanes``,
    rounded by largest remainder so that they sum to ``lanes``."""
    shares = np.array([float(mix.get(op, 0.0)) for op in OPS])
    if abs(shares.sum() - 100.0) > 1e-6:
        raise ValueError(f"op shares sum to {shares.sum()}, not 100")
    exact = shares / 100.0 * lanes
    counts = np.floor(exact).astype(np.int64)
    short = lanes - int(counts.sum())
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[:short]] += 1
    return counts


@dataclass
class Round:
    index: int
    ops: np.ndarray | None     # int64[B, 3]: opcode, key1, key2 (-1)
    pairs: np.ndarray | None   # int64[Q, 2]: source key, target key
    batches: list | None = None   # [(client id, int64[B, 3])] of a
                                  # ``clients`` mix, in client order


class Traffic:
    """Round ``r`` of a mix's stream, generated in order."""

    def __init__(self, mix: dict, n_loaded: int, sources: np.ndarray,
                 seed_seq):
        self.n = int(n_loaded)
        self.churn = int(mix["churn_keys"])
        self.keys = self.n + self.churn
        self.sources = np.asarray(sources, np.int64)
        self.lag = int(mix["rem_e_lag_rounds"])
        sub = mix.get("submit")
        if sub and mix.get("clients"):
            raise ValueError("a mix has submit or clients, not both")
        self.every = int(sub["every"]) if sub else 0
        self.counts = lane_counts(int(sub["lanes"]), sub["mix"]) if sub else None
        cl = mix.get("clients")
        self.clients = int(cl["count"]) if cl else 0
        self.client_counts = (lane_counts(int(cl["lanes"]), cl["mix"])
                              if cl else None)
        ex = cl.get("exclusive") if cl else None
        self.exclusive_every = int(ex["every"]) if ex else 0
        self.exclusive_counts = (lane_counts(int(ex["lanes"]), ex["mix"])
                                 if ex else None)
        gp = mix.get("getpath")
        self.queries = int(gp["queries"]) if gp else 0
        self.rng = np.random.default_rng(seed_seq)
        self.added = deque()       # (due round, u, v) of AddE pairs, in order
        self.next_round = 0

    def submits_at(self, r: int) -> bool:
        return self.every > 0 and r % self.every == 0

    def _batch(self, r: int, counts: np.ndarray) -> np.ndarray:
        rng = self.rng
        c = dict(zip(OPS, (int(x) for x in counts)))
        opc = np.repeat([OPCODE[op] for op in OPS], counts)
        opc = opc[rng.permutation(len(opc))]
        k1 = np.full(len(opc), -1, np.int64)
        k2 = np.full(len(opc), -1, np.int64)
        for op in ("AddV", "RemV"):
            at = opc == OPCODE[op]
            k1[at] = self.n + rng.integers(0, self.churn, c[op])
        at = opc == OPCODE["ConV"]
        k1[at] = rng.integers(0, self.keys, c["ConV"])
        at = opc == OPCODE["ConE"]
        k1[at] = rng.integers(0, self.keys, c["ConE"])
        k2[at] = rng.integers(0, self.keys, c["ConE"])
        adds = np.flatnonzero(opc == OPCODE["AddE"])
        k1[adds] = rng.integers(0, self.n, len(adds))
        k2[adds] = rng.integers(0, self.n, len(adds))
        # RemE lanes take the due pairs first in, first out, in lane order
        for lane in np.flatnonzero(opc == OPCODE["RemE"]):
            if self.added and self.added[0][0] <= r:
                _, k1[lane], k2[lane] = self.added.popleft()
            else:
                k1[lane], k2[lane] = rng.integers(0, self.n, 2)
        for lane in adds:
            self.added.append((r + self.lag, k1[lane], k2[lane]))
        return np.stack([opc.astype(np.int64), k1, k2], axis=1)

    def next(self) -> Round:
        r = self.next_round
        self.next_round += 1
        ops = self._batch(r, self.counts) if self.submits_at(r) else None
        batches = None
        if self.clients:
            batches = [(f"c{i}", self._batch(r, self.client_counts))
                       for i in range(self.clients)]
            if self.exclusive_every and r % self.exclusive_every == 0:
                batches.append((f"c{self.clients}",
                                self._batch(r, self.exclusive_counts)))
        pairs = None
        if self.queries:
            src = self.sources[self.rng.integers(0, len(self.sources),
                                                 self.queries)]
            dst = self.rng.integers(0, self.n, self.queries)
            pairs = np.stack([src, dst], axis=1)
        return Round(r, ops, pairs, batches)
