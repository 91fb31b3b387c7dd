#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases (each prints lines; the last line is the JSON result):
  1. device: the card's name and power limit (nvidia-smi), the kernel build
  2. kernels: B1 (multi push), B2 (pull) and B3 (single push) against their
     plain PyTorch versions on the card, bit for bit (tolerance 0: every
     output is an integer or a bool), over densities 0 / 0.01 / 0.3, V in
     {2000, 2048}, Q in {1, 5, 16, 70}, an edge in column 31 and row slices;
     then multi_bfs / bfs on "hybrid_cuda" against "hybrid" at V = 4096,
     Q = 8 on a Graph500 graph, every result field
  3. main path at full size: a Graph500 SCALE-16 graph (65,536 vertices,
     1,048,576 generated edges, A/B/C/D = 0.57/0.19/0.19/0.05) in a state of
     capacity 69,632; 8 rounds of one ``apply_ops_fast`` batch
     (B = 1024, the paper's "equal" mix), one ``get_paths_session`` (Q = 64;
     in rounds 1 and 5 a mutator commits a batch on the first two fetches,
     so the double collect must retry) and one ``get_path_session``
  4. checks: the first batch equals ``apply_ops``; the transpose invariant
     holds at the end; every matched answer equals scipy's BFS on the live
     edges of the state it was validated on, and every path is a chain of
     live edges; each kernel was launched on the main path
  5. the device's busy and idle share over one batch, one session and one
     single session (torch.profiler; Chrome traces in
     build/chip_smoke_traces/)
  6. per-kernel times at full size (CUDA events, L2 flushed between
     launches) on inputs captured from one more Q = 64 traversal, beside
     the plain versions' times and the bytes/operations bound

It imports nothing of JAX and nothing of the JAX package. It exits non-zero
without a result when no CUDA device is present or the port is missing.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SCALE = 16
EDGEFACTOR = 16
CAPACITY = 69_632            # 2**16 keys + 4,096 free slots for re-adds
LANES = 1024
QUERIES = 64
ROUNDS = 8
MIX = (12.5, 12.5, 25, 12.5, 12.5, 25)   # AddV RemV HasV AddE RemE HasE
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
ALU_OPS_PER_S = 67e12        # float32 outside the tensor cores (32-bit ALU)


def log(*a):
    print(*a, flush=True)


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------------------------
# Data
# ----------------------------------------------------------------------------
def graph500_edges(scale: int, edgefactor: int, rng):
    """The Graph500 Kronecker generator (reference kronecker_generator):
    R-MAT bits with A=0.57, B=0.19, C=0.19, then a random relabelling of the
    vertices and a shuffle of the edges. Returns (u, v) int64 arrays."""
    n, m = 1 << scale, edgefactor << scale
    a, b, c = 0.57, 0.19, 0.19
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    u = np.zeros(m, np.int64)
    v = np.zeros(m, np.int64)
    for ib in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        u |= ii.astype(np.int64) << ib
        v |= jj.astype(np.int64) << ib
    perm = rng.permutation(n)
    order = rng.permutation(m)
    return perm[u][order], perm[v][order]


def pack_edges(rows, cols, cap: int) -> np.ndarray:
    """uint32[cap, ceil(cap/32)] words with bit (r, c) set for each
    (distinct) edge."""
    w = -(-cap // 32)
    idx = rows * w + cols // 32
    bits = np.left_shift(np.uint32(1), (cols % 32).astype(np.uint32))
    order = np.argsort(idx, kind="stable")
    idx, bits = idx[order], bits[order]
    starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
    words = np.zeros(cap * w, np.uint32)
    words[idx[starts]] = np.bitwise_or.reduceat(bits, starts)
    return words.reshape(cap, w)


def graph500_state_arrays(scale: int, cap: int, rng):
    """The six state arrays of a Graph500 graph: keys 0..n-1 in slots
    0..n-1, vver 1 on live slots, ecnt = distinct out-degree (what AddE
    lanes would leave: duplicate edges collapse, self-loops stay)."""
    n = 1 << scale
    u, v = graph500_edges(scale, EDGEFACTOR, rng)
    e = np.unique(u * n + v)
    u, v = e // n, e % n
    vkey = np.full(cap, -1, np.int32)
    vkey[:n] = np.arange(n, dtype=np.int32)
    valive = np.zeros(cap, np.bool_)
    valive[:n] = True
    vver = valive.astype(np.int32)
    ecnt = np.bincount(u, minlength=cap).astype(np.int32)
    return (vkey, valive, vver, ecnt, pack_edges(u, v, cap),
            pack_edges(v, u, cap)), len(e)


def equal_mix_batch(rng, n_keys: int, device):
    from repro_torch.convert import op_batch_from_numpy
    from repro_torch.core import (OP_ADD_E, OP_ADD_V, OP_CON_E, OP_CON_V,
                                  OP_REM_E, OP_REM_V)

    ops = np.array([OP_ADD_V, OP_REM_V, OP_CON_V, OP_ADD_E, OP_REM_E,
                    OP_CON_E], np.int32)
    opc = rng.choice(ops, size=LANES, p=np.array(MIX) / 100)
    k1 = rng.integers(0, n_keys, LANES)
    k2 = rng.integers(0, n_keys, LANES)
    return op_batch_from_numpy(opc, k1, k2, np.full(LANES, -1), device)


def random_words(rng, v: int, density: float):
    """(bool[v, v] adjacency as packed uint32 words) with extra edges in
    columns 31 and 63 (the int32 sign bit of a word)."""
    bits = rng.random((v, v)) < density
    bits[0, 31] = bits[v // 2, 31] = bits[v - 1, 63] = True
    padded = np.zeros((v, -(-v // 32) * 32), np.bool_)
    padded[:, :v] = bits
    return np.packbits(padded, axis=1, bitorder="little").view(np.uint32)


# ----------------------------------------------------------------------------
# Timing
# ----------------------------------------------------------------------------
class Timer:
    """Per-launch device time from CUDA events, with L2 flushed between
    launches (a 64 MiB write) and the flush's own time subtracted."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")
        self.flush_ms = self._raw(lambda: None, 20)

    def _raw(self, fn, reps):
        torch = self.torch
        fn()
        self.flush_buf.zero_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            self.flush_buf.zero_()
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def ms(self, fn, reps):
        return max(0.0, self._raw(fn, reps) - self.flush_ms)


# ----------------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------------
def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"build: {len(paths)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, so in paths.items():
        log_file = so.with_suffix(".log")
        lines = log_file.read_text().splitlines() if log_file.exists() else []
        regs = [ln.split("info    : ")[-1] for ln in lines if "registers" in ln]
        log(f"  {name}: " + " | ".join(regs))
    return card


def _kernel_mods():
    from repro_torch.kernels.bfs_multi_step import ops as b1
    from repro_torch.kernels.bfs_pull_step import ops as b2
    from repro_torch.kernels.bfs_step import ops as b3

    return {"B1": b1, "B2": b2, "B3": b3}


def reset_counts():
    for m in _kernel_mods().values():
        m.launches = 0


def counts():
    return {k: m.launches for k, m in _kernel_mods().items()}


def phase_kernels(torch, rng):
    """Every kernel against its plain version on the card, bit for bit."""
    from repro_torch.core.graph import pack_bits
    from repro_torch.kernels.bfs_multi_step.ops import (
        multi_bfs_step_packed_kernel)
    from repro_torch.kernels.bfs_multi_step.ref import (
        multi_bfs_step_packed_ref)
    from repro_torch.kernels.bfs_pull_step.ops import bfs_pull_step_rows
    from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref
    from repro_torch.kernels.bfs_step.ops import bfs_step_packed_kernel
    from repro_torch.kernels.bfs_step.ref import bfs_step_packed_ref

    dev = DEVICE
    cases = 0

    def same(a, b, what):
        for x, y in zip(a, b):
            if not torch.equal(x, y):
                raise AssertionError(f"kernel != plain: {what}")

    for v in (2000, 2048):
        for dens in (0.0, 0.01, 0.3):
            adj_np = random_words(rng, v, dens)
            adj = torch.from_numpy(adj_np.view(np.int32)).to(dev)
            bits = torch.from_numpy(np.unpackbits(
                adj_np.view(np.uint8), axis=1, bitorder="little")[:, :v]
                .astype(np.bool_)).to(dev)
            adj_in = pack_bits(bits.T.contiguous())
            alive = torch.from_numpy(rng.random(v) < 0.9).to(dev)
            for q in (1, 5, 16, 70):        # 70: B2's second query group
                fr = torch.from_numpy(rng.random((q, v)) < 0.05).to(dev)
                fr[0, 0] = True
                if q > 1:
                    fr[-1] = False          # an empty frontier
                vis = torch.from_numpy(rng.random((q, v)) < 0.3).to(dev)
                args = (fr, adj, alive, vis)
                same(multi_bfs_step_packed_kernel(*args),
                     multi_bfs_step_packed_ref(*args), f"B1 v={v} q={q}")
                r0, r1 = v // 4, v // 4 + 700    # a row slice, R < V
                sl = (fr[:, r0:r1].contiguous(), adj[r0:r1], alive, vis)
                same(multi_bfs_step_packed_kernel(*sl),
                     multi_bfs_step_packed_ref(*sl), f"B1 slice v={v}")
                fw = pack_bits(fr & alive[None, :])
                pa = (fw, adj_in, alive, vis)
                same(bfs_pull_step_rows(*pa), bfs_pull_step_ref(*pa),
                     f"B2 v={v} q={q}")
                ps = (fw, adj_in[r0:r1], alive[r0:r1],
                      vis[:, r0:r1].contiguous())
                same(bfs_pull_step_rows(*ps), bfs_pull_step_ref(*ps),
                     f"B2 slice v={v}")
                sa = (fr[0], adj, alive, vis[0])
                same(bfs_step_packed_kernel(*sa), bfs_step_packed_ref(*sa),
                     f"B3 v={v}")
                cases += 1
    sync(torch)
    log(f"kernels vs plain: {cases} cases x (B1, B1 slice, B2, B2 slice, "
        f"B3) bit-identical (tolerance 0)")


def phase_hybrid(torch, rng):
    """multi_bfs / bfs: "hybrid_cuda" == "hybrid" on a Graph500 graph."""
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import bfs, multi_bfs

    arrays, _ = graph500_state_arrays(12, 4096, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    deg = arrays[3]
    srcs = rng.choice(np.flatnonzero(deg > 0), 8).astype(np.int32)
    dsts = rng.integers(-1, 4096, 8).astype(np.int32)
    reset_counts()
    a = multi_bfs(st, srcs, dsts, backend="hybrid_cuda")
    b = multi_bfs(st, srcs, dsts, backend="hybrid")
    for f, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"multi_bfs hybrid_cuda != hybrid: {f}")
    for s, d in zip(srcs[:4], dsts[:4]):
        x = bfs(st, int(s), int(d), backend="hybrid_cuda")
        y = bfs(st, int(s), int(d), backend="hybrid")
        for f, p, q in zip(x._fields, x, y):
            if not torch.equal(p, q):
                raise AssertionError(f"bfs hybrid_cuda != hybrid: {f}")
    n = counts()
    if min(n.values()) == 0:
        raise AssertionError(f"a kernel did not run in the hybrid check: {n}")
    log(f"hybrid_cuda == hybrid at V=4096 Q=8 (supersteps "
        f"{int(a.supersteps)}, steps {a.steps.tolist()})")
    log(f"kernels: B1 multi_bfs_step_packed {n['B1']} launches, B2 "
        f"bfs_pull_step {n['B2']}, B3 bfs_step_packed {n['B3']} "
        f"(hybrid_cuda check)")


def check_answers(state, pairs, answers, tag):
    """Each answer against scipy's BFS on the live edges of ``state``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    from repro_torch.core.graph import traversable_packed, unpack_bits

    v = state.capacity
    live = traversable_packed(state.adj_packed, state.valive,
                              state.alive_words)
    rows, cols = [], []
    for r0 in range(0, v, 4096):
        nz = unpack_bits(live[r0:r0 + 4096], v).nonzero()
        rows.append((nz[:, 0] + r0).cpu().numpy())
        cols.append(nz[:, 1].cpu().numpy())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    g = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(v, v))
    vkey = state.vkey.cpu().numpy()
    valive = state.valive.cpu().numpy()
    slot_of = {int(vkey[s]): int(s) for s in np.flatnonzero(valive)}
    srcs = [slot_of.get(k, -1) for k, _ in pairs]
    uniq = sorted({s for s in srcs if s >= 0})
    dist = (shortest_path(g, unweighted=True, indices=uniq)
            if uniq else np.zeros((0, v)))
    row_of = {s: i for i, s in enumerate(uniq)}
    edge_ids = np.sort(rows.astype(np.int64) * v + cols)

    def is_chain(slots):
        e = np.asarray(slots[:-1], np.int64) * v + np.asarray(slots[1:])
        i = np.searchsorted(edge_ids, e)
        return bool(np.all((i < len(edge_ids))
                           & (edge_ids[np.minimum(i, len(edge_ids) - 1)] == e)))

    for (k, l), s, (found, keys) in zip(pairs, srcs, answers):
        d = slot_of.get(l, -1)
        hops = dist[row_of[s], d] if s >= 0 and d >= 0 else np.inf
        if found != bool(np.isfinite(hops)):
            raise AssertionError(f"{tag}: found {found} for {k}->{l}, "
                                 f"scipy hops {hops}")
        if found:
            if len(keys) != int(hops) + 1 or keys[0] != k or keys[-1] != l:
                raise AssertionError(f"{tag}: path {k}->{l} of "
                                     f"{len(keys)} vertices, want {hops + 1}")
            if not is_chain([slot_of[x] for x in keys]):
                raise AssertionError(f"{tag}: path {k}->{l} is not a chain "
                                     f"of live edges")
    return len(edge_ids)


def phase_main(torch, rng, rounds: int):
    from repro_torch.convert import state_from_numpy
    from repro_torch.core import (apply_ops, apply_ops_fast,
                                  get_path_session, get_paths_session,
                                  transpose_invariant)
    from repro_torch.obs import trace

    n = 1 << SCALE
    t0 = time.perf_counter()
    arrays, n_edges = graph500_state_arrays(SCALE, CAPACITY, rng)
    st = state_from_numpy(*arrays, device=DEVICE)
    sync(torch)
    log(f"graph500: SCALE {SCALE}, {n} vertices, {EDGEFACTOR << SCALE} "
        f"generated edges, {n_edges} distinct, capacity {CAPACITY}, state "
        f"{sum(t.numel() * t.element_size() for t in st) / 1e9:.3f} GB, "
        f"built in {time.perf_counter() - t0:.1f} s")
    deg_src = np.flatnonzero(arrays[3][:n] > 0)
    del arrays

    batches = [equal_mix_batch(rng, n, DEVICE) for _ in range(rounds + 4)]
    extra = iter(batches[rounds:])
    pair_sets = [list(zip(rng.choice(deg_src, QUERIES).tolist(),
                          rng.integers(0, n, QUERIES).tolist()))
                 for _ in range(rounds)]
    singles = [(int(rng.choice(deg_src)), int(rng.integers(0, n)))
               for _ in range(rounds)]

    # first batch: the fast engine against the serial specification
    fast_st, fast_res = apply_ops_fast(st, batches[0])
    ser_st, ser_res = apply_ops(st, batches[0])
    for f, x, y in zip(("codes",) + st._fields, (fast_res,) + fast_st,
                       (ser_res,) + ser_st):
        if not torch.equal(x, y):
            raise AssertionError(f"apply_ops_fast != apply_ops: {f}")
    del fast_st, ser_st
    log(f"apply_ops_fast == apply_ops on batch 0 (codes + 6 arrays, "
        f"B={LANES})")

    cur = {"st": st}
    apply_s, session_s, single_s = [], [], []
    rounds_seen, single_rounds = [], []
    supersteps, pulls = [], []
    per_session, per_single = [], []   # kernel launches per session
    checked_edges = []
    reset_counts()
    with trace.capture() as rec:
        for r in range(rounds):
            sync(torch)
            t0 = time.perf_counter()
            cur["st"], _ = apply_ops_fast(cur["st"], batches[r])
            sync(torch)
            apply_s.append(time.perf_counter() - t0)

            mutate = {"left": 2 if r in (1, 5) else 0}
            seen = []

            def fetch():
                if mutate["left"]:
                    mutate["left"] -= 1
                    cur["st"], _ = apply_ops_fast(cur["st"], next(extra))
                seen.append(cur["st"])
                return cur["st"]

            n_ev = len(rec.events())
            c0 = counts()
            t0 = time.perf_counter()
            out, nr = get_paths_session(fetch, pair_sets[r])
            sync(torch)
            session_s.append(time.perf_counter() - t0)
            c1 = counts()
            per_session.append({k: c1[k] - c0[k] for k in c0})
            rounds_seen.append(nr)
            steps = [e for e in rec.events()[n_ev:]
                     if e["name"] == "bfs.superstep"]
            supersteps.append(len(steps))
            pulls.append(sum(e["args"]["direction"] == "pull" for e in steps))
            k, l = singles[r]
            t0 = time.perf_counter()
            pr = get_path_session(lambda: cur["st"], k, l)
            c2 = counts()
            per_single.append({k: c2[k] - c1[k] for k in c1})
            sync(torch)
            single_s.append(time.perf_counter() - t0)
            single_rounds.append(int(pr.rounds))
            keys = pr.keys[:int(pr.length)].tolist()
            # the single session ran on the state the batch session matched
            checked_edges.append(check_answers(
                seen[-1], pair_sets[r] + [(k, l)],
                out + [(bool(pr.found), keys)], f"round {r}"))
            log(f"round {r}: apply {apply_s[-1] * 1e3:.3f} ms, session "
                f"{session_s[-1] * 1e3:.3f} ms ({nr} collects, "
                f"{supersteps[-1]} supersteps, {pulls[-1]} pull), found "
                f"{sum(f for f, _ in out)}/{QUERIES}; single "
                f"{single_s[-1] * 1e3:.3f} ms ({int(pr.rounds)} collects, "
                f"found {bool(pr.found)})")
    launches = counts()
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    if max(rounds_seen) <= 2:
        raise AssertionError("no session needed more than 2 collects")
    if not bool(transpose_invariant(cur["st"])):
        raise AssertionError("transpose invariant broken after the last round")
    med = statistics.median
    log(f"main path medians: apply_ops_fast {med(apply_s) * 1e3:.3f} ms/batch"
        f" (B={LANES}), get_paths_session {med(session_s) * 1e3:.3f} ms "
        f"(Q={QUERIES}), get_path_session {med(single_s) * 1e3:.3f} ms; "
        f"collects per session {rounds_seen}, single {single_rounds}; "
        f"supersteps {supersteps}, pull {pulls}")
    log(f"checks: transpose invariant holds; {rounds} sessions + {rounds} "
        f"single sessions equal scipy BFS (live edges {checked_edges[-1]})")
    log(f"main-path launches: {launches}; per get_paths_session "
        f"{per_session}; per get_path_session {per_single}")
    return cur["st"], launches, pair_sets[0], batches[0]


def _busy_ms(trace_file: Path):
    """(device busy ms, {kernel name: ms}) from a Chrome trace: the union
    of the kernel / memcpy / memset intervals on the card."""
    events = json.loads(trace_file.read_text())["traceEvents"]
    spans, per_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            name = re.sub(r"^void |\(anonymous namespace\)::", "",
                          e["name"])
            name = re.split(r"[(<]", name)[0][:40].strip()
            per_name[name] = per_name.get(name, 0.0) + e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, per_name


def phase_profile(torch, st, pairs, batch):
    """Device busy share of one batch, one session and one single session
    (torch.profiler; Chrome traces written to build/chip_smoke_traces/)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (apply_ops_fast, get_path_session,
                                  get_paths_session)

    out_dir = ROOT / "build" / "chip_smoke_traces"
    out_dir.mkdir(parents=True, exist_ok=True)
    work = {
        "apply_ops_fast": lambda: apply_ops_fast(st, batch),
        "get_paths_session": lambda: get_paths_session(lambda: st, pairs),
        "get_path_session": lambda: get_path_session(lambda: st, *pairs[0]),
    }
    for name, fn in work.items():
        fn()
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(torch)
            wall = (time.perf_counter() - t0) * 1e3
        trace_file = out_dir / f"chip_smoke_{name}.json"
        prof.export_chrome_trace(str(trace_file))
        busy, per_name = _busy_ms(trace_file)
        if not per_name:
            log(f"profile {name}: wall {wall:.3f} ms; device busy not "
                f"measured (no device events in the trace)")
            continue
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"profile {name}: wall {wall:.3f} ms under the profiler, device "
            f"busy {busy:.3f} ms (idle {100 * (1 - busy / wall):.1f}%); "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in top))


def phase_kernel_times(torch, st, pairs, launches, timer):
    """Time each kernel on inputs captured from one Q=64 traversal."""
    from repro_torch.core import bfs, find_slots, multi_bfs
    from repro_torch.kernels.bfs_multi_step import ref as b1ref
    from repro_torch.kernels.bfs_pull_step import ref as b2ref
    from repro_torch.kernels.bfs_step import ref as b3ref

    mods = _kernel_mods()
    entry = {"B1": "multi_bfs_step_packed_kernel", "B2": "bfs_pull_step_rows",
             "B3": "bfs_step_packed_kernel"}
    plain = {"B1": b1ref.multi_bfs_step_packed_ref,
             "B2": b2ref.bfs_pull_step_ref,
             "B3": b3ref.bfs_step_packed_ref}
    captured = {k: [] for k in mods}
    originals = {k: getattr(m, entry[k]) for k, m in mods.items()}

    def recorder(key):
        def rec(*args):
            # the adjacency (argument 1) is the state's and stays unchanged
            captured[key].append(tuple(a if i == 1 else a.clone()
                                       for i, a in enumerate(args)))
            return originals[key](*args)
        return rec

    for k, m in mods.items():
        setattr(m, entry[k], recorder(k))
    try:
        dev = st.device
        ks = torch.tensor([p[0] for p in pairs], dtype=torch.int32, device=dev)
        ls = torch.tensor([p[1] for p in pairs], dtype=torch.int32, device=dev)
        multi_bfs(st, find_slots(st, ks), find_slots(st, ls),
                  backend="hybrid_cuda")
        # one single-query traversal to the end: B3 pushes, then B2 pulls
        bfs(st, find_slots(st, ks[:1]), -1, backend="hybrid_cuda")
    finally:
        for k, m in mods.items():
            setattr(m, entry[k], originals[k])
    sync(torch)

    out = []
    meta = {
        "B1": ("multi_bfs_step_packed", "bfs_multi_step",
               "src/repro/kernels/bfs_multi_step/kernel.py:232"),
        "B2": ("bfs_pull_step", "bfs_pull_step",
               "src/repro/kernels/bfs_pull_step/kernel.py:139"),
        "B3": ("bfs_step_packed", "bfs_step",
               "src/repro/kernels/bfs_step/kernel.py:165"),
    }
    for key, calls in captured.items():
        name, pkg, replaces = meta[key]
        kern = originals[key]
        ms, pms, bms, bys, err = [], [], [], [], 0
        for args in calls:
            got = kern(*args)
            want = plain[key](*args)
            for x, y in zip(got, want):
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: kernel != plain at full "
                                         f"size")
            err = max(err, max(int((x.to(torch.int64) - y.to(torch.int64))
                                   .abs().max()) for x, y in zip(got, want)))
            ms.append(timer.ms(lambda: kern(*args), 20))
            pms.append(timer.ms(lambda: plain[key](*args), 2))
            nbytes, nops = _work(torch, key, args, want)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ALU_OPS_PER_S
            bms.append(max(t_bytes, t_ops) * 1e3)
            bys.append("bytes" if t_bytes >= t_ops else "operations")
        shapes = sorted({tuple(tuple(a.shape) for a in c[:2]) for c in calls})
        log(f"{name} ({key}): {len(calls)} captured launches at shapes "
            f"{shapes}: kernel {statistics.mean(ms):.4f} ms/launch, plain "
            f"{statistics.mean(pms):.3f} ms, bound {statistics.mean(bms):.4f}"
            f" ms ({max(set(bys), key=bys.count)})")
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{pkg}/kernel.cu",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err, "ms": statistics.mean(ms),
            "plain_ms": statistics.mean(pms),
            "bound_ms": statistics.mean(bms),
            "bound_by": max(set(bys), key=bys.count), "library_ms": None,
        })
    return out


def _work(torch, key, args, want):
    """(bytes, 32-bit word operations) one call needs on these inputs: each
    input byte read once, each output written once; for the adjacency only
    the words the data requires."""
    if key in ("B1", "B3"):
        fr, adj, alive, vis = args
        fr2 = fr.reshape(-1, fr.shape[-1])
        w = adj.shape[1]
        rows = int(fr2.any(0).sum())
        per_q = int(fr2.sum())
        outs = sum(t.numel() * t.element_size() for t in want)
        nbytes = (fr.numel() + rows * w * 4 + alive.numel() + vis.numel()
                  + outs)
        return nbytes, 2 * per_q * w
    fw, adj_in, alive, vis = args
    new, parent = want
    w = adj_in.shape[1]
    pending = alive[None, :] & ~vis & (fw != 0).any(1)[:, None]
    need = torch.where(pending, torch.where(new, parent // 32 + 1, w), 0)
    words = int(need.amax(0).sum()) if need.numel() else 0
    outs = new.numel() + parent.numel() * 4
    nbytes = fw.numel() * 4 + words * 4 + alive.numel() + vis.numel() + outs
    return nbytes, 2 * int(need.sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    t_all = time.perf_counter()
    card = phase_device(torch)
    phase_kernels(torch, rng)
    phase_hybrid(torch, rng)
    st, launches, pairs, batch = phase_main(torch, rng, ROUNDS)
    phase_profile(torch, st, pairs, batch)
    timer = Timer(torch)
    kernels = phase_kernel_times(torch, st, pairs, launches, timer)
    log(f"card: {card}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
