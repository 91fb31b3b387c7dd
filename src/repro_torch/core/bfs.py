"""BFS over the packed graph state, in PyTorch: the port of ``repro.core.bfs``.

One superstep expands every frontier at once:

    reach[j]  = OR_i  frontier[i] AND adj[i, j]
    parent[j] = min_i { i : frontier[i] AND adj[i, j] }
    new       = reach AND alive AND NOT visited

Backends (every one gives bit-identical results):

  "dense"        plain torch on the unpacked [V, V] view (JAX "jnp")
  "packed"       plain torch OR-reduction over the packed words
  "hybrid"       direction-optimizing: per-superstep popcounts pick the
                 packed push or the bottom-up pull over ``adj_in_packed``
                 (Beamer's alpha/beta switch), plain torch
  "packed_cuda"  push through the CUDA kernels (B3 single, B1 multi)
  "hybrid_cuda"  the hybrid switch with push = B3/B1 and pull = B2
  "dense_cuda"   push through the dense CUDA kernels (B7 single, B6 multi)
                 on the unpacked uint8 [V, V] view (JAX "pallas"), built
                 once per call outside the superstep loop

``backend=None`` resolves through ``default_backend``: the kernel hybrid on
a CUDA state, the plain hybrid on a CPU state; ``REPRO_TORCH_BFS_BACKEND``
overrides both.

JAX fuses the supersteps into one ``lax.while_loop``; here the loop runs on
the host with ONE device-to-host sync per superstep, which carries the loop
test (any query active) and the two popcounts the direction switch needs.
The same loop body serves the plain and the traced runs: with tracing on,
each superstep is one ``bfs.superstep`` span with its direction tag and
popcounts.

Closure mode (``parents=False``, the index builds) keeps only ``new``. On
the kernel backends each superstep runs the B1 push or the B2 pull, or
the B6 dense push, with ``parents=False`` (they compute and write no
parent), where JAX keeps closure mode in plain jnp: XLA fuses its
where+reduce (or, for "pallas", multiplies by a float32 [V, V] operand,
19.4 GB at V = 69,632), but eager torch would
materialize a [Q, V, W] word volume (tens of GB at the index's Q), so on
the card the kernels are what keeps the closure inside memory. The plain
backends keep the plain closure.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import (
    INT32_MAX,
    WORD_BITS,
    GraphState,
    or_reduce,
    pack_bits,
    popcount,
    traversable,
    traversable_packed,
    unpack_bits,
)
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import global_registry as _obs_registry

BACKENDS = ("dense", "packed", "hybrid", "packed_cuda", "hybrid_cuda",
            "dense_cuda")
PACKED_BACKENDS = ("packed", "packed_cuda")
DENSE_BACKENDS = ("dense", "dense_cuda")
HYBRID_BACKENDS = ("hybrid", "hybrid_cuda")
CUDA_BACKENDS = ("packed_cuda", "hybrid_cuda", "dense_cuda")

# Beamer-style switch: go bottom-up when |frontier| * alpha >= |unvisited|,
# return top-down once |frontier| < V / beta (the JAX package's defaults).
DEFAULT_ALPHA = WORD_BITS
DEFAULT_BETA = 64

BACKEND_ENV = "REPRO_TORCH_BFS_BACKEND"


def default_backend(device=None) -> str:
    """The BFS backend for ``device`` (the one resolution point of every
    ``backend=None``): "hybrid_cuda" on CUDA, "hybrid" elsewhere;
    ``REPRO_TORCH_BFS_BACKEND`` overrides."""
    env = os.environ.get(BACKEND_ENV)
    if env:
        return env
    dev = torch.device("cuda" if device is None else device)
    return "hybrid_cuda" if dev.type == "cuda" else "hybrid"


def _resolve_backend(backend: str | None, device) -> str:
    backend = default_backend(device) if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown bfs backend {backend!r}")
    return backend


# ----------------------------------------------------------------------------
# Plain single-frontier step functions
# ----------------------------------------------------------------------------
def bfs_step_jnp(frontier, adj, alive, visited):
    """Dense reference expansion: (new bool[V], parent int32[V]); parent is
    the smallest frontier row with a traversable edge (-1 if none). The
    expansion and the parent scan read the same ``traversable`` mask."""
    t = traversable(adj, alive)
    sel = frontier[:, None] & t
    new = sel.any(0) & ~visited
    idx = torch.arange(adj.shape[0], dtype=torch.int32, device=adj.device)
    parent = torch.where(sel, idx[:, None], INT32_MAX).amin(0)
    return new, torch.where(new, parent, -1)


def bfs_step_packed_jnp(frontier, adj_packed, alive, visited):
    """Packed expansion: reach is the OR of the frontier rows' traversable
    words. Bit-identical to ``bfs_step_jnp``."""
    v = alive.shape[0]
    t = traversable_packed(adj_packed, alive, pack_bits(alive))
    sel = torch.where(frontier[:, None], t, 0)
    new = unpack_bits(or_reduce(sel, 0), v) & ~visited
    idx = torch.arange(v, dtype=torch.int32, device=alive.device)
    cand = torch.where(frontier[:, None] & unpack_bits(t, v), idx[:, None],
                       INT32_MAX)
    return new, torch.where(new, cand.amin(0), -1)


def ctz32(words: torch.Tensor) -> torch.Tensor:
    """Per-word count of trailing zeros of the low 32 bits (32 for a zero
    word), int32: isolate the lowest set bit, popcount the mask below it.
    In int64, so the top bit's word does not overflow."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    return popcount(((x & -x) - 1) & 0xFFFFFFFF)


def bfs_step_pull_jnp(frontier, adj_in_packed, alive, visited):
    """Bottom-up expansion: every vertex ANDs its in-adjacency row with the
    packed live frontier; parent = lowest set bit = smallest frontier
    source. Bit-identical to ``bfs_step_packed_jnp``."""
    w = adj_in_packed.shape[1]
    fw = pack_bits(frontier & alive)
    cand = adj_in_packed & fw[None, :]
    nz = cand != 0
    new = nz.any(1) & alive & ~visited
    widx = torch.arange(w, dtype=torch.int32, device=alive.device) * WORD_BITS
    pcand = torch.where(nz, widx[None, :] + ctz32(cand), INT32_MAX)
    return new, torch.where(new, pcand.amin(1), -1)


def pick_direction(pulling: bool, nf: int, nu: int, v: int, alpha: int,
                   beta: int) -> bool:
    """The push/pull switch on vertex popcounts: enter pull when the
    frontier reaches 1/alpha of the unvisited set, leave it once the
    frontier drops below V/beta. Products in float32, as in JAX (bfs.py
    pick_direction), so the choices and direction tags match it."""
    f32 = np.float32
    if pulling:
        # repro-torch-lint: allow(trace-purity) — numpy scalars of the superstep's popcounts, no device value
        return bool(f32(nf) * f32(beta) >= f32(v))
    # repro-torch-lint: allow(trace-purity) — numpy scalars of the superstep's popcounts, no device value
    return bool(f32(nf) * f32(alpha) >= f32(nu))


# ----------------------------------------------------------------------------
# Plain Q-frontier step functions
# ----------------------------------------------------------------------------
def multi_bfs_step_jnp(frontiers, adj, alive, visited):
    """Dense reference expansion for Q frontiers (a [V, Q, V] candidate
    volume): (new bool[Q, V], parent int32[Q, V])."""
    t = traversable(adj, alive)
    sel = frontiers.T[:, :, None] & t[:, None, :]
    new = sel.any(0) & ~visited
    idx = torch.arange(adj.shape[0], dtype=torch.int32, device=adj.device)
    parent = torch.where(sel, idx[:, None, None], INT32_MAX).amin(0)
    return new, torch.where(new, parent, -1)


def multi_bfs_step_packed_jnp(frontiers, adj_packed, alive, visited):
    """Packed expansion for Q frontiers. Bit-identical to
    ``multi_bfs_step_jnp``."""
    v = alive.shape[0]
    t = traversable_packed(adj_packed, alive, pack_bits(alive))
    sel = torch.where(frontiers[:, :, None], t[None, :, :], 0)
    new = unpack_bits(or_reduce(sel, 1), v) & ~visited
    idx = torch.arange(v, dtype=torch.int32, device=alive.device)
    cand = torch.where(frontiers.T[:, :, None] & unpack_bits(t, v)[:, None, :],
                       idx[:, None, None], INT32_MAX)
    return new, torch.where(new, cand.amin(0), -1)


def multi_bfs_step_pull_jnp(frontiers, adj_in_packed, alive, visited):
    """Bottom-up expansion for Q frontiers (a [Q, V, W] word volume).
    Bit-identical to ``multi_bfs_step_packed_jnp``."""
    w = adj_in_packed.shape[1]
    fw = pack_bits(frontiers & alive[None, :])
    cand = adj_in_packed[None, :, :] & fw[:, None, :]
    nz = cand != 0
    new = nz.any(2) & alive[None, :] & ~visited
    widx = torch.arange(w, dtype=torch.int32, device=alive.device) * WORD_BITS
    pcand = torch.where(nz, widx[None, None, :] + ctz32(cand), INT32_MAX)
    return new, torch.where(new, pcand.amin(2), -1)


def _step_fns(backend: str, multi: bool):
    """(push_fn, pull_fn) of a backend; pull_fn is None for the
    single-direction backends. Kernel wrappers are imported here, at call
    time."""
    if backend == "dense":
        return (multi_bfs_step_jnp if multi else bfs_step_jnp), None
    if backend == "packed":
        return (multi_bfs_step_packed_jnp if multi
                else bfs_step_packed_jnp), None
    if backend == "hybrid":
        if multi:
            return multi_bfs_step_packed_jnp, multi_bfs_step_pull_jnp
        return bfs_step_packed_jnp, bfs_step_pull_jnp
    if backend == "dense_cuda":
        from repro_torch.kernels.bfs_multi_step.ops import multi_bfs_step
        from repro_torch.kernels.bfs_step.ops import bfs_step
        return (multi_bfs_step if multi else bfs_step), None
    from repro_torch.kernels.bfs_multi_step.ops import multi_bfs_step_packed
    from repro_torch.kernels.bfs_pull_step.ops import (bfs_pull_step,
                                                       multi_bfs_pull_step)
    from repro_torch.kernels.bfs_step.ops import bfs_step_packed

    push = multi_bfs_step_packed if multi else bfs_step_packed
    if backend == "packed_cuda":
        return push, None
    return push, (multi_bfs_pull_step if multi else bfs_pull_step)


# ----------------------------------------------------------------------------
# The superstep loop (shared by bfs and multi_bfs, plain and traced)
# ----------------------------------------------------------------------------
class MultiBFSResult(NamedTuple):
    found: torch.Tensor      # bool[Q]    dst reached (per query)
    parent: torch.Tensor     # int32[Q,V] per-query BFS tree (-1 root/unvisited)
    dist: torch.Tensor       # int32[Q,V] per-query BFS depth (-1 unvisited)
    expanded: torch.Tensor   # bool[Q,V]  rows whose adjacency this query read
    steps: torch.Tensor      # int32[Q]   per-query frontier expansions
    supersteps: torch.Tensor  # int32     shared loop iterations run


class BFSResult(NamedTuple):
    found: torch.Tensor      # bool      dst reached
    parent: torch.Tensor     # int32[V]  BFS tree (-1 root/unvisited)
    dist: torch.Tensor       # int32[V]  BFS depth (-1 unvisited)
    expanded: torch.Tensor   # bool[V]   rows whose adjacency was read
    steps: torch.Tensor      # int32     frontier expansions


def _as_slots(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(-1)
    return torch.as_tensor(np.asarray(x, np.int32).reshape(-1), device=device)


def _run(state: GraphState, src, dst, backend: str, parents: bool,
         alpha: int, beta: int, multi: bool) -> MultiBFSResult:
    """The superstep loop for Q (src, dst) pairs: one sync per superstep."""
    dev = state.device
    q, v = src.shape[0], state.capacity
    alive = state.valive
    qi = torch.arange(q, device=dev)
    hybrid = backend in HYBRID_BACKENDS
    push_fn, pull_fn = _step_fns(backend, multi)
    # the dense backends get the unpacked view, built once per call
    adj_arg = state.adj if backend in DENSE_BACKENDS else state.adj_packed
    kernel_closure = not parents and backend in CUDA_BACKENDS
    if kernel_closure:
        # B1/B2 and B6 compute and write no parent in closure mode
        push_fn = functools.partial(push_fn, parents=False)
        pull_fn = pull_fn and functools.partial(pull_fn, parents=False)
    if not parents and not kernel_closure:
        # plain closure mode, as in JAX; the expansion operand is hoisted
        # out of the loop
        closure_op = (traversable(adj_arg, alive).to(torch.float32)
                      if backend == "dense" else
                      traversable_packed(state.adj_packed, alive,
                                         pack_bits(alive)))

    src_ok = (src >= 0) & alive[src.clamp(min=0)]
    frontiers = torch.zeros((q, v), dtype=torch.bool, device=dev)
    frontiers[qi, src.clamp(min=0)] = src_ok
    visited = frontiers.clone()
    parent = torch.full((q, v), -1, dtype=torch.int32, device=dev)
    dist = torch.where(frontiers, 0, -1).to(torch.int32)
    expanded = torch.zeros((q, v), dtype=torch.bool, device=dev)
    steps = torch.zeros((q,), dtype=torch.int32, device=dev)
    dst_c = dst.clamp(min=0)
    has_dst = dst >= 0
    unvisited_live = alive[None, :] & ~visited

    def one_query(fn):
        # single-frontier step fns (B3 and its plain forms) on the Q=1 carry
        def step(f, a, al, vis):
            new, par = fn(f[0], a, al, vis[0])
            return new[None], par[None]
        return step

    if not multi:
        push_fn = one_query(push_fn)
        pull_fn = pull_fn and one_query(pull_fn)

    reg = _obs_registry()
    # as in JAX, only the multi-source engine is traced: the single-source
    # ``bfs`` records no span and moves no bfs.* metric
    tracing = multi and _trace.enabled()
    span = _trace.span if tracing else _trace.null_span
    pulling = False
    last_dir = None
    step = 0
    with span("bfs.session", queries=q, capacity=v, backend=backend,
              parents=parents) as session:
        while step < v:
            act = frontiers.any(1) & ~(has_dst & visited[qi, dst_c])
            f = frontiers & act[:, None]
            nu_t = (unvisited_live & act[:, None]).sum()
            # the superstep's one sync: loop test and the switch's popcounts
            # repro-torch-lint: allow(trace-purity) — the superstep's one sync (JAX's host loop reads the same)
            any_act, nf, nu = torch.stack(
                [act.any().to(nu_t.dtype), f.sum(), nu_t]).tolist()
            if not any_act:
                break
            with span("bfs.superstep", step=step, frontier_pop=nf,
                      unvisited_pop=nu) as sp:
                if hybrid:
                    pulling = pick_direction(pulling, nf, nu, q * v, alpha,
                                             beta)
                expanded |= f
                if parents or kernel_closure:
                    if pulling:
                        new, par = pull_fn(f, state.adj_in_packed, alive,
                                           visited)
                    else:
                        new, par = push_fn(f, adj_arg, alive, visited)
                    if parents:
                        parent = torch.where(new, par, parent)
                else:
                    new = _closure_step(f, visited, closure_op, alive,
                                        state.adj_in_packed, v,
                                        pulling, backend)
                dist = torch.where(new, step + 1, dist)
                visited |= new
                unvisited_live &= ~new
                steps += act.to(torch.int32)
                frontiers = new
                if tracing:
                    _trace.fence(new)
                direction = "pull" if pulling else "push"
                sp.set(direction=direction)
            if tracing:
                reg.inc("bfs.supersteps")
                if direction == "pull":
                    reg.inc("bfs.pull_supersteps")
                if last_dir is not None and direction != last_dir:
                    reg.inc("bfs.direction_flips")
            last_dir = direction
            step += 1
        session.set(supersteps=step)
    found = has_dst & visited[qi, dst_c] & src_ok
    return MultiBFSResult(found, parent, dist, expanded, steps,
                          torch.tensor(step, dtype=torch.int32, device=dev))


def _closure_step(f, visited, closure_op, alive, adj_in_packed, v, pulling,
                  backend):
    """One closure-only expansion (``parents=False``): no parent scan."""
    if backend == "dense":
        return ((f.to(torch.float32) @ closure_op) > 0) & ~visited
    if pulling:
        fw = pack_bits(f & alive[None, :])
        cand = adj_in_packed[None, :, :] & fw[:, None, :]
        return (cand != 0).any(2) & alive[None, :] & ~visited
    sel = torch.where(f[:, :, None], closure_op[None, :, :], 0)
    return unpack_bits(or_reduce(sel, 1), v) & ~visited


def multi_bfs(state: GraphState, src_slots, dst_slots,
              backend: str | None = None, parents: bool = True,
              alpha: int = DEFAULT_ALPHA,
              beta: int = DEFAULT_BETA) -> MultiBFSResult:
    """Fused BFS from Q sources with per-query early exit.

    Per-query results are bit-identical to Q single ``bfs`` calls, but each
    superstep advances all Q frontiers with one expansion, so the adjacency
    is streamed once per superstep. Finished queries expose an empty
    frontier (their outputs freeze). ``dst_slots[q] < 0`` explores query
    q's whole reachable set. ``parents=False`` is closure-only mode:
    ``parent`` comes back all -1, everything else is unchanged; the kernel
    backends run it through B1/B2 (B6 on "dense_cuda") without parents,
    the plain backends in plain torch. The hybrid backends pick push or
    pull per superstep from the active queries' pooled popcounts."""
    backend = _resolve_backend(backend, state.device)
    src = _as_slots(src_slots, state.device)
    dst = _as_slots(dst_slots, state.device)
    return _run(state, src, dst, backend, parents, alpha, beta, multi=True)


def bfs(state: GraphState, src_slot, dst_slot, backend: str | None = None,
        alpha: int = DEFAULT_ALPHA, beta: int = DEFAULT_BETA) -> BFSResult:
    """BFS from ``src_slot`` with early exit at ``dst_slot`` (< 0 explores
    the whole reachable set). Traversable edge: adj[u, w] & alive[u] &
    alive[w]. On "packed_cuda"/"hybrid_cuda" the push runs B3, on
    "dense_cuda" B7."""
    backend = _resolve_backend(backend, state.device)
    src = _as_slots(src_slot, state.device)
    dst = _as_slots(dst_slot, state.device)
    r = _run(state, src, dst, backend, True, alpha, beta, multi=False)
    return BFSResult(r.found[0], r.parent[0], r.dist[0], r.expanded[0],
                     r.steps[0])


def extract_path(parent, src_slot: int, dst_slot: int):
    """Walk the BFS tree from dst back to src on the host. Returns
    (length, slots int32[V] numpy): ``slots[:length]`` is the path src..dst
    in order, padded with -1 (the paper's p-pointer trace in GetPath)."""
    # repro-torch-lint: allow(trace-purity) — the path walk runs on the host: one copy of parent[V]
    par = (parent.cpu().numpy() if isinstance(parent, torch.Tensor)
           else np.asarray(parent))  # repro-torch-lint: allow(trace-purity) — already on the host
    v = par.shape[0]
    rev = []
    cur = int(dst_slot)
    while cur >= 0 and len(rev) < v:
        rev.append(cur)
        cur = -1 if cur == src_slot else int(par[cur])
    out = np.full((v,), -1, np.int32)
    out[:len(rev)] = rev[::-1]
    return len(rev), out


def reachable_count(state: GraphState, src_slot,
                    backend: str | None = None) -> torch.Tensor:
    """|{w : src ->* w}|."""
    r = bfs(state, src_slot, -1, backend=backend)
    return (r.dist >= 0).sum().to(torch.int32)
