"""Obstruction-free GetPath via double collect (the paper's §3.5), in
PyTorch: the port of ``repro.core.snapshot``.

A collect is one BFS TreeCollect plus a snapshot of the validation vector
(ecnt, vver) over the rows the traversal depended on. Two consecutive
collects match iff their dependency sets, parent trees, found flags and
masked version vectors are equal; matching collects prove the traversal
saw a graph state that existed unchanged across the second collect, so
the answer linearizes inside it. The §3.5 adversary (add an edge, remove
it between collects) bumps a source-row ecnt in the dependency set, so it
is always caught.

Surfaces:
  * ``collect`` / ``compare_collects`` / ``get_path``: pure building blocks
  * ``get_path_session``: the protocol against a live state reference
  * ``collect_batch`` / ``get_paths_session``: Q queries under ONE shared
    double collect, traversed by the fused ``multi_bfs``
  * ``interleaved_getpath``: mutation batches interleaved with a pending
    query, one collect per round (a host loop where JAX uses ``lax.scan``)

Paths are walked where the forest lies (``kernels/path_walk``: one launch
on the card, the plain walk on the host otherwise), and a session copies
home only the found flags, the lengths and the path keys.

Every surface also takes a mesh-partitioned ``core.partition.
ShardedGraphState`` (DESIGN.md §8): the traversal is then the sharded
fused BFS (a single collect runs it at Q = 1, untraced, where JAX runs its
untraced single-source ``bfs`` on the sharded arrays), and since the
validation metadata is replicated the Collect is bit-identical to the
dense one.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import ops as gops
from repro_torch.core import partition
from repro_torch.core.bfs import bfs, multi_bfs
from repro_torch.core.graph import (GraphState, OpBatch, find_slot,
                                    find_slots, version_vector)
from repro_torch.kernels.path_walk import ops as pw_ops
from repro_torch.kernels.path_walk.ref import CAP as PATH_CAP
from repro_torch.obs import trace as _trace


class Collect(NamedTuple):
    found: torch.Tensor     # bool
    parent: torch.Tensor    # int32[V]
    touched: torch.Tensor   # bool[V]  dependency set (expanded + {src, dst})
    versions: torch.Tensor  # int32[V, 2]  (ecnt, vver) masked to touched
    src_slot: torch.Tensor  # int32
    dst_slot: torch.Tensor  # int32
    present: torch.Tensor   # bool  both endpoints alive at collect start


class PathResult(NamedTuple):
    found: torch.Tensor   # bool: a path existed (linearizably)
    length: torch.Tensor  # int32: vertices on the path (0 if none)
    keys: torch.Tensor    # int32[V]: keys along the path, -1 padded
    rounds: torch.Tensor  # int32: collects performed
    starved: torch.Tensor  # bool: the double collect never matched within
    # the retry budget; with on_conflict="epoch" the answer was resolved
    # against one pinned epoch


def _require_state(state) -> None:
    if not isinstance(state, (GraphState, partition.ShardedGraphState)):
        raise TypeError(f"a collect takes a GraphState or a "
                        f"ShardedGraphState, got {type(state).__name__}")


def _touch(touched, slots):
    """touched[q, s] |= s >= 0 for each query's slot."""
    q = slots.shape[0]
    qi = torch.arange(q, device=slots.device)
    s = slots.clamp(min=0)
    touched[qi, s] = touched[qi, s] | (slots >= 0)


def _finish(state: GraphState, found, parent, expanded, sk, sl) -> Collect:
    """Dependency-set and version bookkeeping after a [Q]-batched
    traversal."""
    present = (sk >= 0) & (sl >= 0)
    touched = expanded.clone()
    _touch(touched, sk)
    _touch(touched, sl)
    vv = torch.where(touched[:, :, None], version_vector(state)[None], 0)
    return Collect(found & present, parent, touched, vv, sk, sl, present)


def collect(state: GraphState, k, l, backend: str | None = None) -> Collect:
    """One TreeCollect: locate endpoints, BFS (the push is B3 on the
    kernel backends), snapshot versions."""
    _require_state(state)
    sk = find_slot(state, int(k)).reshape(1)
    sl = find_slot(state, int(l)).reshape(1)
    if isinstance(state, partition.ShardedGraphState):
        r = partition.traverse(state, sk, sl, backend=backend)
        c = _finish(state, r.found, r.parent, r.expanded, sk, sl)
    else:
        r = bfs(state, sk, sl, backend=backend)
        c = _finish(state, r.found[None], r.parent[None], r.expanded[None],
                    sk, sl)
    return Collect(*(x[0] for x in c))


def compare_collects(a: Collect, b: Collect) -> torch.Tensor:
    """The paper's CompareTree + ComparePath, subsumed by version equality.
    Works on single collects and on batches alike (all queries must
    match)."""
    same_tree = torch.equal(torch.where(a.touched, a.parent, -1),
                            torch.where(b.touched, b.parent, -1))
    same = (same_tree and torch.equal(a.touched, b.touched)
            and torch.equal(a.versions, b.versions)
            and torch.equal(a.found, b.found)
            and torch.equal(a.present, b.present)
            and torch.equal(a.src_slot, b.src_slot)
            and torch.equal(a.dst_slot, b.dst_slot))
    return torch.tensor(same)


compare_collect_batches = compare_collects


def _materialize(state: GraphState, c: Collect, rounds,
                 starved=False) -> PathResult:
    """The PathResult of one collect, on the state's device: one walk
    whose row holds the whole path (a cap of V keys)."""
    dev = state.device
    row = pw_ops.path_walk(c.parent[None], c.found.reshape(1),
                           c.src_slot.reshape(1), c.dst_slot.reshape(1),
                           state.vkey, cap=state.capacity)[0]
    return PathResult(
        row[0] != 0, row[1], row[2:],
        torch.tensor(int(rounds), dtype=torch.int32, device=dev),
        torch.tensor(bool(starved), device=dev))  # repro-torch-lint: allow(trace-purity) — a host flag


def get_path(state: GraphState, k, l,
             backend: str | None = None) -> PathResult:
    """GetPath against a static state: a single collect is trivially a
    valid double collect."""
    return _materialize(state, collect(state, k, l, backend=backend), 1)


# ----------------------------------------------------------------------------
# Batched multi-query GetPath under ONE shared double collect
# ----------------------------------------------------------------------------
def collect_batch(state, ks, ls, backend: str | None = None,
                  engine: str = "fused") -> Collect:
    """TreeCollect for Q query pairs; the Collect's leading axis is the
    query. One version comparison validates all of them against the same
    pair of states, so every answer linearizes at the same point.

    ``engine="fused"``: one ``multi_bfs`` advancing all Q frontiers per
    superstep (the production path; the push is B1 on the kernel
    backends). ``engine="vmap"``: Q single collects, stacked (the
    cross-check reference)."""
    _require_state(state)
    dev = state.device
    # repro-torch-lint: allow(trace-purity) — host key lists in, not device tensors
    ks = torch.as_tensor(np.asarray(ks, np.int32), device=dev)
    ls = torch.as_tensor(np.asarray(ls, np.int32), device=dev)  # repro-torch-lint: allow(trace-purity) — host key lists in
    if engine == "vmap":
        # the cross-check engine copies the keys to the host once
        cs = [collect(state, int(k), int(l), backend=backend)
              for k, l in zip(ks.tolist(), ls.tolist())]  # repro-torch-lint: allow(trace-purity) — the cross-check engine's one copy
        return Collect(*(torch.stack(f) for f in zip(*cs)))
    if engine != "fused":
        raise ValueError(f"unknown collect_batch engine {engine!r}")
    sk = find_slots(state, ks)
    sl = find_slots(state, ls)
    traverse = (partition.multi_bfs
                if isinstance(state, partition.ShardedGraphState)
                else multi_bfs)
    r = traverse(state, sk, sl, backend=backend)
    return _finish(state, r.found, r.parent, r.expanded, sk, sl)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as numpy, under a ``session.to_host`` span with its bytes."""
    with _trace.span("session.to_host", bytes=t.numel() * t.element_size()):
        return t.cpu().numpy()


def _materialize_batch(state, cur: Collect, pairs):
    """(found, keys) per pair: every path walked where the forest lies,
    then one copy home of the flags, the lengths and the first PATH_CAP
    keys a pair (V, where fewer), and, where a path is longer, one more
    walk and copy at the longest length."""
    with _trace.span("session.materialize", pairs=len(pairs)):
        args = (cur.parent, cur.found, cur.src_slot, cur.dst_slot,
                state.vkey)
        cap = min(PATH_CAP, state.capacity)
        engine = "device" if cur.parent.is_cuda else "host"
        with _trace.span("session.path_walk", engine=engine) as walk:
            block = _to_host(pw_ops.path_walk(*args, cap=cap))
            hops = int(block[:, 1].max()) if len(block) else 0
            if hops > cap:
                block = _to_host(pw_ops.path_walk(*args, cap=hops))
            walk.set(hops=hops)
        return [(bool(r[0]), r[2:2 + r[1]].tolist()) for r in block]


def _session_stats(stats, *, rounds, starved, resolved, epoch):
    if stats is not None:
        stats.update(rounds=rounds, starved=starved, resolved=resolved,
                     epoch=epoch)


def get_paths_session(fetch_state, pairs, *, max_rounds: int | None = 16,
                      backend: str | None = None, engine: str = "fused",
                      on_conflict: str = "retry", fetch_epoch=None,
                      stats: dict | None = None):
    """Multi-query GetPath: the double-collect loop runs once for the whole
    batch. Returns ([(found, keys)] per pair, rounds).

    ``max_rounds`` bounds the retry loop (None: the paper's unbounded
    loop). At the budget, ``on_conflict="retry"`` gives up (every pair
    (False, [])); ``"epoch"`` resolves wait-free with one collect over
    ``fetch_epoch()``'s pinned ``(epoch, state)`` (``fetch_state()`` when
    None). ``stats`` receives {"rounds", "starved", "resolved", "epoch"}.
    """
    if on_conflict not in ("retry", "epoch"):
        raise ValueError(f"unknown on_conflict mode {on_conflict!r}")
    ks = [p[0] for p in pairs]
    ls = [p[1] for p in pairs]

    def one(state):
        return _trace.fence(collect_batch(state, ks, ls, backend=backend,
                                          engine=engine))

    with _trace.span("session.get_paths", pairs=len(pairs),
                     on_conflict=on_conflict) as sp:
        state = fetch_state()
        with _trace.span("collect.round", round=1):
            prev = one(state)
        rounds = 1
        while True:
            state = fetch_state()
            with _trace.span("collect.round", round=rounds + 1):
                cur = one(state)
            rounds += 1
            with _trace.span("session.compare"):
                # a capacity grow between collects is an effective mutation
                same = (prev.versions.shape == cur.versions.shape
                        and bool(compare_collect_batches(prev, cur)))
            if same:
                _session_stats(stats, rounds=rounds, starved=False,
                               resolved="match", epoch=None)
                sp.set(rounds=rounds, resolved="match")
                return _materialize_batch(state, cur, pairs), rounds
            prev = cur
            if max_rounds is not None and rounds >= max_rounds:
                if on_conflict == "epoch":
                    epoch, state = (fetch_epoch() if fetch_epoch is not None
                                    else (None, fetch_state()))
                    with _trace.span("collect.round", round=rounds + 1,
                                     pinned=True):
                        cur = one(state)
                    rounds += 1
                    _session_stats(stats, rounds=rounds, starved=True,
                                   resolved="epoch", epoch=epoch)
                    sp.set(rounds=rounds, resolved="epoch")
                    return _materialize_batch(state, cur, pairs), rounds
                _session_stats(stats, rounds=rounds, starved=True,
                               resolved="budget", epoch=None)
                sp.set(rounds=rounds, resolved="budget")
                return [(False, []) for _ in pairs], rounds


def get_path_session(
    fetch_state: Callable[[], GraphState],
    k: int,
    l: int,
    max_rounds: int | None = 16,
    backend: str | None = None,
    *,
    on_conflict: str = "retry",
    fetch_epoch=None,
) -> PathResult:
    """The paper's GetPath/Scan against a live state reference:
    ``fetch_state()`` returns the mutator's latest published state.
    Terminates at the first pair of consecutive collects with no effective
    mutation between them; at the ``max_rounds`` budget, "retry" returns
    found=False with ``starved``, "epoch" answers from one pinned
    ``fetch_epoch()`` state with ``starved``."""
    if on_conflict not in ("retry", "epoch"):
        raise ValueError(f"unknown on_conflict mode {on_conflict!r}")
    state = fetch_state()
    prev = collect(state, k, l, backend=backend)
    rounds = 1
    while True:
        state = fetch_state()
        cur = collect(state, k, l, backend=backend)
        rounds += 1
        if (prev.versions.shape == cur.versions.shape
                and bool(compare_collects(prev, cur))):
            return _materialize(state, cur, rounds)
        prev = cur
        if max_rounds is not None and rounds >= max_rounds:
            if on_conflict == "epoch":
                state = (fetch_epoch()[1] if fetch_epoch is not None
                         else fetch_state())
                cur = collect(state, k, l, backend=backend)
                return _materialize(state, cur, rounds + 1, starved=True)
            dev = state.device
            return PathResult(
                torch.tensor(False, device=dev),
                torch.tensor(0, dtype=torch.int32, device=dev),
                torch.full((state.capacity,), -1, dtype=torch.int32,
                           device=dev),
                torch.tensor(rounds, dtype=torch.int32, device=dev),
                torch.tensor(True, device=dev))


# ----------------------------------------------------------------------------
# Interleaving mutation batches with a pending query
# ----------------------------------------------------------------------------
def interleaved_getpath(state: GraphState, batches: OpBatch, k, l,
                        backend: str | None = None, engine: str = "fast"):
    """Run T rounds of (apply mutation batch t, advance the query by one
    collect); the query completes at the first collect that matches the
    previous round's. ``batches`` has a leading T axis. Returns
    (final state, PathResult, per-round result codes int32[T, B]). Never
    matching reports found=False, rounds=-1 and starved."""
    apply = gops.apply_ops_fast if engine == "fast" else gops.apply_ops
    prev = collect(state, k, l, backend=backend)
    ans, done_round, results = prev, -1, []
    for t in range(batches.opcode.shape[0]):
        state, res = apply(state, OpBatch(*(x[t] for x in batches)))
        results.append(res)
        if done_round >= 0:
            continue  # answered: the remaining rounds only mutate
        cur = collect(state, k, l, backend=backend)
        # repro-torch-lint: allow(trace-purity) — the double collect decides when to stop: one scalar a round
        if bool(compare_collects(prev, cur)):
            ans, done_round = cur, t + 1
        prev = cur
    done = done_round >= 0
    if not done:
        ans = prev
    pr = _materialize(state, ans, done_round + 1 if done else -1)
    pr = PathResult(pr.found & done,
                    pr.length if done else torch.zeros_like(pr.length),
                    pr.keys, pr.rounds, torch.tensor(not done,
                                                     device=state.device))
    return state, pr, torch.stack(results)
