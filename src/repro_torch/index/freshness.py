"""Epoch validation: serving from the index as a cached double collect, in
PyTorch: the port of ``repro.index.freshness`` (DESIGN.md §9).

The index carries the (ecnt, vver) version vector of the state it was
built from. At serve time the live vector is compared with it, exactly the
check ``compare_collects`` makes between two collects, with the stamp as
the first collect: equality proves the graph is the build state (counters
are monotone), so every index answer linearizes at the comparison point.
On a mismatch the session falls back to the fused BFS double collect
(``get_paths_session``); undecided queries of a partial index take the
same fallback.

``refresh`` restores freshness. Rows whose versions advanced are "dirty".
A forward closure can change only if its landmark reached a dirty row; a
backward closure also when the NEW graph's forward closure of the dirty
rows holds its landmark (one more closure-mode BFS, Q = |dirty|). Only the
affected rows are re-traversed, and the landmark list stays fixed, so an
incremental refresh is bit-identical to a full rebuild over the same
landmarks. The closures ``fwd``/``bwd`` stay on the device throughout.

Not ported yet: validation against the epoch ring (``on_conflict="epoch"``
with a ``ring``, ROADMAP.md queue A7) and sharded states (A10).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core.bfs import multi_bfs
from repro_torch.core.graph import find_slots, version_vector
from repro_torch.core.snapshot import get_paths_session
from repro_torch.index.labels import (ReachIndex, _require_dense,
                                      build_index, coverage_complete, pad8,
                                      rebuild_rows)
from repro_torch.index.query import query_reach, reach_counts
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import global_registry as _obs_registry


def index_fresh(index: ReachIndex | None, state) -> bool:
    """True iff the live version metadata equals the index's build stamp
    (the second half of the double collect). A capacity change is a
    mismatch."""
    if index is None or state.capacity != index.capacity:
        return False
    return bool(torch.equal(version_vector(state), index.versions))


def affected_landmarks(index: ReachIndex, state, *,
                       backend: str | None = None):
    """(aff_fwd bool[L], aff_bwd bool[L], dirty bool[V]) as numpy: the
    landmark closures a refresh must re-traverse (module docstring)."""
    _require_dense(state)
    dirty = (version_vector(state) != index.versions).any(1)
    lm = index.landmarks.long()
    aff_fwd = (index.fwd & dirty[None, :]).any(1) | dirty[lm]
    aff_bwd = (index.bwd & dirty[None, :]).any(1) | dirty[lm]
    dirty_np = dirty.cpu().numpy()
    if dirty_np.any() and lm.numel():
        dslots = torch.from_numpy(
            pad8(np.nonzero(dirty_np)[0].astype(np.int32))).to(state.device)
        res = multi_bfs(state, dslots, torch.full_like(dslots, -1),
                        backend=backend, parents=False)
        aff_bwd |= (res.dist >= 0).any(0)[lm]
    return aff_fwd.cpu().numpy(), aff_bwd.cpu().numpy(), dirty_np


def refresh(index: ReachIndex, state, *, backend: str | None = None,
            full_threshold: float = 0.5):
    """Bring a stale index up to the state's epoch: (index, info) with info
    = {"mode": "noop" | "incremental" | "full", "rebuilt": landmark
    closures re-traversed}. Rebuilds from scratch (fresh landmark pick) when
    capacity changed, when a complete index lost completeness, or when more
    than ``full_threshold`` of the closures are affected. The caller swaps
    the returned index in; the old one is not written."""
    if state.capacity != index.capacity:
        return (build_index(state, index.requested, backend=backend),
                {"mode": "full", "rebuilt": index.num_landmarks})
    aff_fwd, aff_bwd, dirty = affected_landmarks(index, state,
                                                 backend=backend)
    if not dirty.any():
        return index, {"mode": "noop", "rebuilt": 0}
    if index.requested is None and not coverage_complete(
            index.landmarks, state.valive, index.capacity):
        # a complete index must stay complete: re-pick the landmarks
        return (build_index(state, None, backend=backend),
                {"mode": "full", "rebuilt": index.num_landmarks})
    n = int(aff_fwd.sum()) + int(aff_bwd.sum())
    if index.num_landmarks and n > full_threshold * 2 * index.num_landmarks:
        return (build_index(state, index.requested, backend=backend),
                {"mode": "full", "rebuilt": index.num_landmarks})
    return (rebuild_rows(index, state, aff_fwd, aff_bwd, backend=backend),
            {"mode": "incremental", "rebuilt": n})


@dataclass
class ReachSessionResult:
    """Batched reachability answers plus lazy path materialization.

    ``found[q]`` linearizes at the freshness check (index-served) or inside
    its BFS double-collect session (fallback). ``paths()`` runs a fresh
    fused-BFS session over all pairs on demand."""

    found: list[bool]
    from_index: int   # queries answered on the index fast path
    fellback: int     # queries answered by the BFS double-collect session
    stale: bool       # an epoch mismatch sent the whole batch to BFS
    rounds: int       # collect rounds of the BFS session (0 if none)
    _materialize: Callable = field(repr=False, default=lambda: [])
    pinned_epoch: int | None = None  # epoch the answers linearize at when
    # the BFS session resolved against ``fetch_epoch()`` (on_conflict="epoch")
    starved: bool = False            # the BFS session hit its retry budget
    degraded: bool = False           # answered off a recovering server's
    # pinned epoch (set by the server, ROADMAP.md queue A8)

    def paths(self):
        """[(found, keys)] per pair: witness paths via the fused BFS."""
        return self._materialize()


def reach_session(fetch_state, index: ReachIndex | None, pairs, *,
                  engine: str = "fused", backend: str | None = None,
                  join_backend: str | None = None, max_rounds: int = 64,
                  on_conflict: str = "retry", fetch_epoch=None, ring=None
                  ) -> ReachSessionResult:
    """Answer Q (k, l) key-pair reachability queries against a live state
    reference, preferring the index.

    Fresh index: slot lookup plus one label join (B4 on the card; see
    ``query.py`` for ``join_backend``) answers every decided query, and the
    freshness comparison is the snapshot validation. Undecided queries run
    the ``get_paths_session`` fallback; a stale index sends the whole batch
    there. ``ring`` (validation at a retained epoch) waits for the epoch
    ring, ROADMAP.md queue A7."""
    if ring is not None:
        raise NotImplementedError(
            "ring-validated serving needs the epoch ring (ROADMAP.md queue "
            "A7), which is not ported yet")
    pairs = list(pairs)
    q = len(pairs)

    def materialize():
        out, _ = get_paths_session(fetch_state, pairs, max_rounds=max_rounds,
                                   backend=backend, engine=engine,
                                   on_conflict=on_conflict,
                                   fetch_epoch=fetch_epoch)
        return out

    if q == 0:
        return ReachSessionResult([], 0, 0, False, 0, materialize)

    def index_serve(state):
        dev = state.device
        ks = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
        ls = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
        # this IS the freshness layer (the rule knows only the JAX path)
        reach, decided, _ = query_reach(  # repro-lint: allow(epoch-freshness)
            index, find_slots(state, ks), find_slots(state, ls),
            backend=join_backend)
        found = [bool(x) for x in reach.cpu().numpy()]
        und = np.nonzero(~decided.cpu().numpy())[0]
        rounds = 0
        starved = False
        if und.size:
            st: dict = {}
            out, rounds = get_paths_session(
                fetch_state, [pairs[i] for i in und], max_rounds=max_rounds,
                backend=backend, engine=engine, on_conflict=on_conflict,
                fetch_epoch=fetch_epoch, stats=st)
            starved = bool(st.get("starved", False))
            for i, (f, _keys) in zip(und, out):
                found[int(i)] = bool(f)
        return ReachSessionResult(found, q - int(und.size), int(und.size),
                                  False, rounds, materialize,
                                  starved=starved)

    def session_body():
        admitted = fetch_epoch()[0] if fetch_epoch is not None else None
        state = fetch_state()
        if index_fresh(index, state):
            return index_serve(state)
        if on_conflict == "epoch" and admitted is not None:
            with _trace.span("index.ring_validate", admitted=admitted):
                t0 = time.perf_counter()
                # without a ring no retained epoch can pin the batch
                if _trace.enabled():
                    _obs_registry().observe("index.ring_validate_s",
                                            time.perf_counter() - t0)
        st: dict = {}
        with _trace.span("index.fallback", pairs=q):
            t0 = time.perf_counter()
            out, rounds = get_paths_session(fetch_state, pairs,
                                            max_rounds=max_rounds,
                                            backend=backend, engine=engine,
                                            on_conflict=on_conflict,
                                            fetch_epoch=fetch_epoch, stats=st)
            if _trace.enabled():
                _obs_registry().observe("index.fallback_s",
                                        time.perf_counter() - t0)
        return ReachSessionResult([bool(f) for f, _ in out], 0, q,
                                  index is not None, rounds, materialize,
                                  pinned_epoch=st.get("epoch"),
                                  starved=bool(st.get("starved", False)))

    with _trace.span("index.query", pairs=q) as sp:
        t0 = time.perf_counter()
        res = session_body()
        sp.set(from_index=res.from_index, fellback=res.fellback,
               stale=res.stale, pinned=res.pinned_epoch)
        if _trace.enabled():
            _obs_registry().observe("index.query_s", time.perf_counter() - t0)
        return res


def reach_counts_session(fetch_state, index: ReachIndex | None, keys, *,
                         backend: str | None = None):
    """Batched ``core.bfs.reachable_count``: (counts int32 numpy[Q],
    served_from_index bool). Index-served when fresh and every count is
    decided (complete cover); otherwise one closure-mode multi-BFS over the
    fetched snapshot (a functional snapshot, so one fetch is consistent)."""
    state = fetch_state()
    _require_dense(state)
    slots = find_slots(state, torch.tensor(list(keys), dtype=torch.int32,
                                           device=state.device))
    if index_fresh(index, state):
        counts, decided = reach_counts(  # repro-lint: allow(epoch-freshness)
            index, slots)
        if bool(decided.all()):
            return counts.cpu().numpy(), True
    res = multi_bfs(state, slots, torch.full_like(slots, -1),
                    backend=backend, parents=False)
    return (res.dist >= 0).sum(1, dtype=torch.int32).cpu().numpy(), False
