"""Pruned 2-hop landmark labels over the fused BFS engine, in PyTorch: the
port of ``repro.index.labels`` (DESIGN.md §9).

A ``ReachIndex`` precomputes reachability through L *landmark* vertices,
picked by degree in the JAX package's order (``pick_landmarks``) or pinned
by the caller:

  fwd[i, v] = landmark i reaches v      (forward closure)
  bwd[i, v] = v reaches landmark i      (backward closure)

Both closures are one closure-mode ``multi_bfs`` each with Q = L sources:
on the graph for ``fwd``, and on the maintained in-adjacency for ``bwd``
(``_reversed``, an O(1) field swap). On the kernel backends the closures
run through B1/B2 (B6 on "dense_cuda"; see ``core/bfs.py``), so the
build never materializes a [Q, V, W] volume.

The labels are the transposed closures with canonical-hub pruning: entry
(v, k) is dropped when an earlier landmark j < k already covers the pair
through v ->* v_j ->* v_k (OUT side) or v_k ->* v_j ->* v (IN side). The
smallest-index hub of every covered pair survives, so the pruned labels
decide the same pairs as the closures. They are stored word-packed over
the landmark axis (int32[V, ceil(L/32)], the JAX package's uint32 bits).

A nonempty label intersection proves reachability. An empty one proves
unreachability only when the landmark set is ``complete`` (every alive
vertex is a landmark); otherwise the pair is undecided and the session
layer (``freshness.py``) falls back to the BFS session.

A mesh-sharded state (``core.partition``) is gathered through ``unshard``
first, as JAX's ``_as_dense`` does.

The index is stamped with the full (ecnt, vver) version vector of the state
it was built from; ``freshness.index_fresh`` compares it with the live
metadata like the second collect of a double collect.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bfs import multi_bfs
from repro_torch.core.graph import (GraphState, pack_bits, popcount,
                                    traversable_packed, unpack_bits,
                                    version_vector)

_DEGREE_ROWS = 4096   # rows per popcount chunk in pick_landmarks


class ReachIndex(NamedTuple):
    """Versioned 2-hop reachability index. Tensor fields live on the
    state's device; ``complete`` and ``requested`` are host metadata."""

    landmarks: torch.Tensor   # int32[L]   landmark slot ids, degree-ordered
    out_label: torch.Tensor   # int32[V, ceil(L/32)] words: v reaches lm i
    in_label: torch.Tensor    # int32[V, ceil(L/32)] words: lm i reaches v
    fwd: torch.Tensor         # bool[L, V] unpruned forward closures
    bwd: torch.Tensor         # bool[L, V] unpruned backward closures
    alive: torch.Tensor       # bool[V]    liveness at build time
    versions: torch.Tensor    # int32[V, 2] (ecnt, vver) build stamp
    complete: bool            # every alive vertex at build is a landmark
    requested: int | None     # landmark budget for full rebuilds (None:
    #                           complete coverage, kept complete by refresh)

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def out_label_bits(self) -> torch.Tensor:
        """Unpacked bool[V, L] view of the packed OUT labels."""
        return unpack_bits(self.out_label, self.num_landmarks)

    @property
    def in_label_bits(self) -> torch.Tensor:
        """Unpacked bool[V, L] view of the packed IN labels."""
        return unpack_bits(self.in_label, self.num_landmarks)


def _as_dense(state) -> GraphState:
    """The dense form of a dense or mesh-sharded state: an index build
    gathers (the backward closure needs the transposed adjacency, and a
    transpose of a row-sharded matrix is a full exchange anyway, DESIGN.md
    §9)."""
    from repro_torch.core.partition import ShardedGraphState, unshard

    if isinstance(state, ShardedGraphState):
        return unshard(state)
    if not isinstance(state, GraphState):
        raise TypeError(f"the index takes a GraphState or a "
                        f"ShardedGraphState, got {type(state).__name__}")
    return state


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _reversed(state: GraphState) -> GraphState:
    """The reverse graph: out- and in-adjacency swapped (an O(1) field
    swap; the maintained in-adjacency IS the transpose). BFS on it from
    landmark i yields {v : v reaches i} = bwd[i]."""
    return state._replace(adj_packed=state.adj_in_packed,
                          adj_in_packed=state.adj_packed)


def pad8(idx: np.ndarray) -> np.ndarray:
    """Pad an index list to a multiple of 8 by repeating its first entry
    (a duplicated BFS source recomputes an identical row). Kept from the
    JAX package, where it bounds the number of jit shapes, so that both
    packages traverse the same source lists."""
    pad = (-len(idx)) % 8
    if pad:
        idx = np.concatenate([idx, np.full((pad,), idx[0], idx.dtype)])
    return idx


def coverage_complete(landmarks, alive, capacity: int) -> bool:
    """Every alive vertex is a landmark: then an empty label intersection
    is an exact negative."""
    is_lm = np.zeros((capacity,), bool)
    is_lm[_host(landmarks)] = True
    return bool(np.all(~_host(alive) | is_lm))


def live_degrees(state: GraphState) -> torch.Tensor:
    """int64[V]: live out-degree + live in-degree of every slot, each the
    popcount of the ``traversable_packed`` rows of one mirror (equal to the
    JAX package's row and column sums of the alive-masked dense matrix by
    the transpose invariant), in row chunks: no [V, V] unpack."""
    state = _as_dense(state)
    alive = state.valive
    aw = pack_bits(alive)
    deg = torch.zeros((state.capacity,), dtype=torch.int64,
                      device=state.device)
    for r0 in range(0, state.capacity, _DEGREE_ROWS):
        r1 = min(state.capacity, r0 + _DEGREE_ROWS)
        for mirror in (state.adj_packed, state.adj_in_packed):
            live = traversable_packed(mirror[r0:r1], alive[r0:r1], aw)
            deg[r0:r1] += popcount(live).sum(1)
    return deg


def pick_landmarks(state: GraphState,
                   num_landmarks: int | None = None) -> np.ndarray:
    """The JAX package's landmark order, alive vertices only; ``None``
    selects every alive vertex (the complete index).

    JAX sorts by the negated degree (``live_degrees``) with ties by slot,
    but its degree is an unsigned sum, so the negation wraps: alive
    vertices of degree 0 come FIRST (slot ascending), then the rest by
    degree descending, ties by slot. That is a fault of the reference
    (ROADMAP.md queue C), matched here so that both packages pick the same
    landmarks: a budget smaller than the number of isolated vertices picks
    only vertices that reach nothing. Callers that want hubs pass
    ``landmark_slots`` to ``build_index``."""
    deg = live_degrees(state).cpu().numpy().astype(np.uint64)
    alive = state.valive.cpu().numpy()
    slots = np.arange(alive.shape[0])
    order = np.lexsort((slots, -deg))          # the wrap: 0 sorts first
    order = order[alive[order]]                # alive only
    if num_landmarks is not None:
        order = order[: max(0, int(num_landmarks))]
    return order.astype(np.int32)


def _prune(fwd: torch.Tensor, bwd: torch.Tensor, landmarks: torch.Tensor):
    """Canonical-hub pruning: one [L, L] landmark-closure matrix and two
    [L, L] @ [L, V] cover products. The operands are 0/1 and the sums at
    most L < 2**24, so float32 (and TF32) products are exact. Returns
    (out_label bool[V, L], in_label bool[V, L])."""
    lgl = fwd[:, landmarks.long()]             # lgl[k, j] = v_k reaches v_j
    f32 = torch.float32
    lt = torch.tril(torch.ones(lgl.shape, dtype=f32, device=lgl.device),
                    diagonal=-1)               # j < k
    # IN bit (k, u) = fwd[k, u] is redundant iff some j < k: v_k ->* v_j ->* u
    cover_in = ((lgl.to(f32) * lt) @ fwd.to(f32)) > 0
    # OUT bit (k, u) = bwd[k, u] is redundant iff some j < k: u ->* v_j ->* v_k
    cover_out = ((lgl.T.to(f32) * lt) @ bwd.to(f32)) > 0
    return (bwd & ~cover_out).T, (fwd & ~cover_in).T


def _full_closure(state: GraphState, sources: torch.Tensor,
                  backend: str | None) -> torch.Tensor:
    """bool[Q, V]: the reachable set of each source (closure mode, dst -1)."""
    dsts = torch.full_like(sources, -1)
    return multi_bfs(state, sources, dsts, backend=backend,
                     parents=False).dist >= 0


def _closures(state: GraphState, lm: torch.Tensor, backend: str | None):
    """Forward and backward closures of the landmark set: two closure-mode
    multi-BFS calls (Q = L), the backward one on ``_reversed(state)``."""
    return (_full_closure(state, lm, backend),
            _full_closure(_reversed(state), lm, backend))


def build_index(state: GraphState, num_landmarks: int | None = None, *,
                landmark_slots=None,
                backend: str | None = None) -> ReachIndex:
    """A ``ReachIndex`` of a state snapshot (a functional snapshot, so one
    fetch is a consistent collect).

    ``num_landmarks=None`` indexes every alive vertex: the index is then
    complete and decides every pair. A smaller budget trades coverage for
    build cost; undecided pairs fall back to the BFS session.
    ``landmark_slots`` pins an explicit slot list (refresh and tests)."""
    state = _as_dense(state)
    v = state.capacity
    dev = state.device
    if landmark_slots is not None:
        lm = _host(landmark_slots).astype(np.int32).reshape(-1)
    else:
        lm = pick_landmarks(state, num_landmarks)
    n = lm.shape[0]
    lm_t = torch.from_numpy(lm.copy()).to(dev)
    if n == 0:
        fwd = torch.zeros((0, v), dtype=torch.bool, device=dev)
        bwd = torch.zeros((0, v), dtype=torch.bool, device=dev)
        out_bits = in_bits = torch.zeros((v, 0), dtype=torch.bool,
                                         device=dev)
    else:
        fwd, bwd = _closures(state, lm_t, backend)
        out_bits, in_bits = _prune(fwd, bwd, lm_t)
    return ReachIndex(
        landmarks=lm_t,
        out_label=pack_bits(out_bits),
        in_label=pack_bits(in_bits),
        fwd=fwd,
        bwd=bwd,
        alive=state.valive,
        versions=version_vector(state),
        complete=coverage_complete(lm, state.valive, v),
        requested=num_landmarks if landmark_slots is None else int(n),
    )


def rebuild_rows(index: ReachIndex, state: GraphState, aff_fwd, aff_bwd,
                 backend: str | None = None) -> ReachIndex:
    """Recompute only the given landmark rows (bool[L] masks) against
    ``state`` and re-prune: the array half of ``freshness.refresh``. The
    landmark list, and so the pruning order, stays fixed, so the result is
    bit-identical to ``build_index(state, landmark_slots=index.landmarks)``.
    The old index's tensors are not written (racing readers keep it)."""
    state = _as_dense(state)
    lm = index.landmarks

    def recompute(mask, mat, g):
        idx = np.nonzero(_host(mask))[0]
        if idx.size == 0:
            return mat
        idx_t = torch.from_numpy(pad8(idx)).to(mat.device)
        mat = mat.clone()
        mat[idx_t] = _full_closure(g, lm[idx_t], backend)
        return mat

    fwd = recompute(aff_fwd, index.fwd, state)
    bwd = recompute(aff_bwd, index.bwd, _reversed(state))
    out_bits, in_bits = _prune(fwd, bwd, lm)
    return index._replace(
        out_label=pack_bits(out_bits), in_label=pack_bits(in_bits),
        fwd=fwd, bwd=bwd, alive=state.valive,
        versions=version_vector(state),
        complete=coverage_complete(lm, state.valive, index.capacity))
