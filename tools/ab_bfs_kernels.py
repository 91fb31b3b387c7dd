#!/usr/bin/env python3
"""Time the port's BFS kernels B1, B2, B3, B6 and B7, its edge writes
B5 and B9 and its dense label join B8 against a parent commit's, on one
NVIDIA GPU, in the same process.

    git archive <parent> | tar -x -C build/parent
    python3 tools/ab_bfs_kernels.py --parent build/parent [--seed 0]
        [--kernels B6,B7]

The parent's ``bfs_multi_step``, ``bfs_pull_step`` and ``bfs_step``
libraries (those the chosen kernels need) are built from
``<parent>/src/repro_torch/kernels/`` with the port's nvcc flags and
called through their C entry points, with the signatures they had at
commit 63a514c (B1, B2 and B6 with the ``parents`` flag, B6/B7 with the
scratch of ``bfs_multi_step.ops.dense_scratch``, B3 with the ``fw``
scratch of the split push); this checkout's kernels run through its own
wrappers. The inputs are captured from this
checkout's path on the ``chip_smoke.py`` cell (a Graph500 SCALE-16 state
of capacity 69,632): one Q = 64 traversal and one single-query traversal
on "hybrid_cuda" (B1, B2, B3), the two closures of one ``build_index``
over the 1,024 highest-degree slots (B1 and B2 at Q = 1,024, which this
checkout may run without parents), and on the dense engine
"dense_cuda" over the 4.849 GB uint8 view: one Q = 64 traversal (B6,
group ``q64``), one Q = 64 closure to the end (B6 as that closure runs
it, group ``q64c``) and one single-query traversal to the end (B7,
group ``q1``).

Every captured launch runs on both versions and the outputs must agree
(``new`` and ``reach``; ``parent`` where both return it). The ``--top``
largest launches of each group are then timed in turns parent, change,
change, parent (CUDA events, L2 flushed between launches) and traced once
each under torch.profiler for the device time of every sub-kernel
(``chip_smoke.Timer``), beside the launch's bound (``chip_smoke._work``:
the bytes or operations these inputs need at the card's peak rates).
Prints one line per group and writes everything to
``build/ab_bfs_kernels.json``.

B5 and B9, which no path launches, run in place on the state's words and
its dense view (``GraphState.adj``) with the lanes of one equal-mix batch
of 1,024 (group ``b1024``: ``chip_smoke.py`` phase 6's input), 2,048
(``b2048``: the one-block cap) and 16,384 (``b16384``: the global-scratch
path, phase 6's ``wide_*`` keys), through the parent's
``edge_update_launch`` / ``edge_update_packed_launch``, each checked
against the plain version first; the launch floor
(``chip_smoke.launch_floor``) is logged beside. Events ms of these
launch-bound kernels include whatever part of the host's enqueue the
timer's L2 flush does not cover, so each group also logs the host's
per-call enqueue wall of both forms, of the change's C call alone
(``c_call``) and of the flush (``host_ms``, no synchronize between calls)
and one torch.profiler trace of the change's wrapper with CPU activities
(``trace_cpu_ms``: the ops and CUDA runtime calls in the trace).

B8, which no path launches, runs through the parent's
``label_join_launch`` (whose signature the redesign kept) beside this
checkout's wrapper on the 0/1 labels of an index built over the 1,024
highest-degree slots, gathered for query pairs and unpacked
(``chip_smoke.b8_rows``): group ``q64``, the 64 pairs of a probe drawn as
phase 7 draws them, and groups ``q1024`` and ``q16384``, pairs of the
index's live slots (``chip_smoke.live_pairs``; 16,384 is phase 6's wide
shape). Each group is checked against the plain version first, then timed
in turns parent, change, change, parent (events ms), once each for device
ms, with its bound and its host cost (``host_cost``), and in turns once
more behind a flush that leaves L2 clean (``clean_l2_ms``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "ab_bfs_kernels.json"
PARENT_BUILD = ROOT / "build" / "ab_parent"
# kernel -> (package, wrapper module attribute, parent C entry point)
KERNELS = {
    "B1": ("bfs_multi_step", "multi_bfs_step_packed_kernel",
           "multi_bfs_step_packed_launch"),
    "B2": ("bfs_pull_step", "bfs_pull_step_rows", "bfs_pull_step_launch"),
    "B3": ("bfs_step", "bfs_step_packed_kernel", "bfs_step_packed_launch"),
    "B6": ("bfs_multi_step", "multi_bfs_step", "multi_bfs_step_launch"),
    "B7": ("bfs_step", "bfs_step", "bfs_step_launch"),
    "B5": ("edge_update", "_launch_packed", "edge_update_packed_launch"),
    "B9": ("edge_update", "_launch_dense", "edge_update_launch"),
    "B8": ("label_join", "label_join", "label_join_launch"),
}
HYBRID = ("B1", "B2", "B3")
DENSE = ("B6", "B7")
EDGE = ("B5", "B9")
EDGE_GROUPS = {"b1024": 1024, "b2048": 2048, "b16384": 16384}
JOIN_GROUPS = (64, 1024, 16384)   # B8's queries a launch


def build_parent(parent: Path, keys) -> dict:
    """Compile the parent's libraries that ``keys`` need, one nvcc each, in
    parallel; returns kernel -> library."""
    from repro_torch.kernels import _build

    PARENT_BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for pkg in sorted({KERNELS[k][0] for k in keys}):
        so = PARENT_BUILD / f"{pkg}.so"
        src = parent / "src" / "repro_torch" / "kernels" / pkg / "kernel.cu"
        procs[pkg] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for pkg, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {pkg} build failed:\n{out}")
        libs[pkg] = ctypes.CDLL(str(so))
    return {k: libs[KERNELS[k][0]] for k in keys}


def _call(lib, fn, *args):
    """A parent entry point on the current stream; raises on an error."""
    import torch

    cfn = getattr(lib, fn)
    cfn.argtypes = [ctypes.c_int if isinstance(a, int) else ctypes.c_void_p
                    for a in args] + [ctypes.c_void_p]
    cfn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    code = cfn(*[a if isinstance(a, int) else a.data_ptr() for a in args],
               stream)
    if code != 0:
        raise RuntimeError(f"parent {fn}: CUDA error {code}")


def parent_fn(key, lib):
    """The parent's kernel as a function of the wrapper's arguments."""
    import torch

    # unchanged since 63a514c
    from repro_torch.kernels.bfs_multi_step.ops import dense_scratch

    e = dict(device="cuda")
    fn = KERNELS[key][2]

    def b1(fr, adj, alive, vis):
        q, r = fr.shape
        w, v = adj.shape[1], alive.shape[0]
        new = torch.empty((q, v), dtype=torch.bool, **e)
        par = torch.empty((q, v), dtype=torch.int32, **e)
        reach = torch.empty((q, w), dtype=torch.int32, **e)
        fw = torch.empty((q, -(-r // 32)), dtype=torch.int32, **e)
        _call(lib, fn, fr, adj, alive, vis, new, par, reach, fw, q, r, w, v,
              1)
        return new, par, reach

    def b2(fw, adj_in, alive, vis):
        q, w = fw.shape
        r = adj_in.shape[0]
        new = torch.empty((q, r), dtype=torch.bool, **e)
        par = torch.empty((q, r), dtype=torch.int32, **e)
        scratch = torch.empty((w + q + w * q,), dtype=torch.int32, **e)
        _call(lib, fn, fw, adj_in, alive, vis, new, par, scratch, q, r, w, 1)
        return new, par

    def b3(f, adj, alive, vis):
        v, w = adj.shape
        new = torch.empty((v,), dtype=torch.bool, **e)
        par = torch.empty((v,), dtype=torch.int32, **e)
        reach = torch.empty((w,), dtype=torch.int32, **e)
        fw = torch.empty((-(-v // 32),), dtype=torch.int32, **e)
        _call(lib, fn, f, adj, alive, vis, new, par, reach, fw, v, w)
        return new, par, reach

    def b6(fr, adj, alive, vis):
        q, r = fr.shape
        v = adj.shape[1]
        new = torch.empty((q, v), dtype=torch.bool, **e)
        par = torch.empty((q, v), dtype=torch.int32, **e)
        qm, ints = dense_scratch(q, r, "cuda")
        _call(lib, fn, fr, adj, alive, vis, new, par, qm, ints, q, r, v, 1)
        return new, par

    def b7(f, adj, alive, vis):
        v = adj.shape[0]
        new = torch.empty((v,), dtype=torch.bool, **e)
        par = torch.empty((v,), dtype=torch.int32, **e)
        qm, ints = dense_scratch(1, v, "cuda")
        _call(lib, fn, f, adj, alive, vis, new, par, qm, ints, v)
        return new, par

    def edge(adj, ecnt, rows, cols, vals, mask):    # in place
        _call(lib, fn, adj, ecnt, rows, cols, vals, mask, rows.shape[0],
              *adj.shape)
        return adj, ecnt

    def b8(out_rows, in_rows):
        q, l = out_rows.shape
        hits = torch.empty((q,), dtype=torch.int32, **e)
        hub = torch.empty((q,), dtype=torch.int32, **e)
        _call(lib, fn, out_rows, in_rows, hits, hub, q, l)
        return hits, hub

    return {"B1": b1, "B2": b2, "B3": b3, "B6": b6, "B7": b7, "B5": edge,
            "B9": edge, "B8": b8}[key]


def host_cost(torch, timer, forms, a, reps):
    """What the host spends on one call of each of ``forms``: the per-call
    enqueue wall over ``reps`` calls with no synchronize between them, the
    same of the timer's flush, and one torch.profiler trace (CPU and CUDA
    activities) of ``forms["change"]``: the traced call's wall, and
    {op: cpu ms a call} of the CPU ops and CUDA runtime calls in the trace,
    largest first."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def enqueue_ms(f):
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        t = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return t

    host = {f: enqueue_ms(lambda: fn(*a)) for f, fn in forms.items()}
    flush = enqueue_ms(timer.flush_buf.zero_)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            forms["change"](*a)
        torch.cuda.synchronize()
        with record_function("call"):
            t0 = time.perf_counter()
            forms["change"](*a)
            wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    ops = {}
    for e in sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total):
        if e.cpu_time_total > 0 and e.key not in ops and len(ops) < 12:
            ops[e.key] = e.cpu_time_total / 1e3 / e.count
    return {"host_ms": host, "flush_host_ms": flush,
            "flush_ms": timer.flush_ms, "traced_call_ms": wall,
            "trace_cpu_ms": ops}


def edge_groups(st, rng, keys, libs, timer, reps, floor):
    """B5/B9 on the state's words / dense view in every ``EDGE_GROUPS``
    group: both forms against the plain version, then timed in place in
    turns parent, change, change, parent, and the host's cost of each
    (``host_cost``); one summary dict a group."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.edge_update import ops, ref

    view = st.adj if "B9" in keys else None
    batches = {g: cs.edge_batch_lanes(torch, st, rng, n)
               for g, n in EDGE_GROUPS.items()}
    results = []
    for key in keys:
        adj = st.adj_packed if key == "B5" else view
        plain = (ref.edge_update_packed_ref if key == "B5"
                 else ref.edge_update_ref)
        for group, lanes in batches.items():
            args = (adj, st.ecnt) + lanes
            forms = {"parent": parent_fn(key, libs[key]),
                     "change": getattr(ops, KERNELS[key][1])}
            want = plain(*args)
            for name, fn in forms.items():
                cs.same(fn(adj.clone(), st.ecnt.clone(), *lanes), want,
                        f"{key} {group} {name}")
            nbytes, nops, peak = cs._work(torch, key, args, want)
            del want
            a = (adj.clone(), st.ecnt.clone()) + lanes
            order = ["parent", "change", "change", "parent"]
            ms = {f: [] for f in forms}
            for f in order:
                ms[f].append(timer.ms(lambda: forms[f](*a), reps))
            dev = {f: timer.device_ms(lambda: forms[f](*a), reps)
                   for f in forms}
            # the change's C call alone, without its wrapper's checks
            n = lanes[0].shape[0]
            nb = ops.scratch_bytes(n)
            scratch = (torch.empty(nb, dtype=torch.uint8, device="cuda")
                       if nb else None)
            entry = "edge_update_packed" if key == "B5" else "edge_update"

            def bare(adj, ecnt, *lanes_):
                _build.launch("edge_update", f"{entry}_scratch_launch",
                              adj.device, adj, ecnt, *lanes_, scratch, n,
                              *adj.shape)
            host = host_cost(torch, timer, {**forms, "c_call": bare}, a,
                             reps)
            del a
            summary = {
                "kernel": key, "group": group, "lanes": lanes[0].shape[0],
                "firing": int((lanes[3] > 0).sum()), "turns": order,
                "ms": ms, "device_ms": {f: d for f, (d, _) in dev.items()},
                "sub_ms": {f: sub for f, (_, sub) in dev.items()},
                "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S,
                                nops / peak) * 1e3, **floor, **host}
            results.append(summary)

            def fmt(x):
                return "not measured" if x is None else f"{x:.4f}"
            cs.log(f"{key} {group} ({summary['lanes']} lanes, "
                   f"{summary['firing']} firing): every form agrees; events "
                   f"ms " + ", ".join(f"{f} {' / '.join(map(fmt, v))}"
                                      for f, v in ms.items())
                   + "; device ms " + ", ".join(
                       f"{f} {fmt(d)}" for f, d in
                       summary["device_ms"].items())
                   + f"; bound {summary['bound_ms']:.6f} ms; floor "
                   f"{floor['floor_ms']:.4f} ms (events), "
                   f"{fmt(floor['floor_device_ms'])} ms (device)")
            cs.log(f"{key} {group} host: enqueue ms a call " + ", ".join(
                f"{f} {v:.4f}" for f, v in host["host_ms"].items())
                + f", flush {host['flush_host_ms']:.4f} (its events ms "
                f"{host['flush_ms']:.4f}); one traced change call "
                f"{host['traced_call_ms']:.4f} ms wall, cpu ms a call: "
                + ", ".join(f"{k} {v:.4f}"
                            for k, v in host["trace_cpu_ms"].items()))
    return results


def clean_l2_ms(torch, fn, reps, buf):
    """Events ms of one ``fn()`` behind a read of ``buf`` (a max over 128
    MiB, which leaves L2 clean where the timer's zero-fill leaves it dirty,
    so that the next kernel also writes those lines back), less the read
    alone."""
    def raw(f):
        buf.max()
        f()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            buf.max()
            f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    return raw(fn) - raw(lambda: None)


def join_groups(st, pairs, hubs, lib, timer, reps, floor, rng):
    """B8 on the unpacked labels of an index over ``hubs``, for the probe's
    ``pairs`` (group q64) and for pairs of live slots (``JOIN_GROUPS``):
    both forms against the plain version, then timed in turns parent,
    change, change, parent, with the host's cost of each; one summary dict
    a group."""
    import torch

    from repro_torch.core import find_slots
    from repro_torch.index import build_index
    from repro_torch.kernels.label_join import ops, ref

    index = build_index(st, landmark_slots=hubs)
    groups = {}
    for n in JOIN_GROUPS:
        if n == cs.QUERIES:
            src, dst = (find_slots(st, torch.tensor(
                [p[i] for p in pairs], dtype=torch.int32, device=st.device))
                for i in (0, 1))
        else:
            src, dst = cs.live_pairs(torch, index, n, rng)
        groups[f"q{n}"] = cs.b8_rows(torch, index, src, dst)
    results = []
    forms = {"parent": parent_fn("B8", lib), "change": ops.label_join}
    read_buf = torch.empty(128 << 20, dtype=torch.uint8, device=st.device)
    for group, a in groups.items():
        want = ref.label_join_ref(*a)
        for name, fn in forms.items():
            cs.same(fn(*a), want, f"B8 {group} {name}")
        nbytes, nops, peak = cs._work(torch, "B8", a, want)
        del want
        order = ["parent", "change", "change", "parent"]
        ms = {f: [] for f in forms}
        for f in order:
            ms[f].append(timer.ms(lambda: forms[f](*a), reps))
        dev = {f: timer.device_ms(lambda: forms[f](*a), reps) for f in forms}
        clean = {f: [] for f in forms}
        for f in order:
            clean[f].append(clean_l2_ms(torch, lambda: forms[f](*a), reps,
                                        read_buf))
        host = host_cost(torch, timer, forms, a, reps)
        summary = {
            "kernel": "B8", "group": group, "shape": list(a[0].shape),
            "out_labels": int((a[0] > 0).sum()), "turns": order, "ms": ms,
            "device_ms": {f: d for f, (d, _) in dev.items()},
            "clean_l2_ms": clean,
            "bound_ms": max(nbytes / cs.HBM_BYTES_PER_S,
                            nops / peak) * 1e3, **floor, **host}
        results.append(summary)

        def fmt(x):
            return "not measured" if x is None else f"{x:.4f}"
        cs.log(f"B8 {group} ({summary['shape']}, {summary['out_labels']} OUT "
               f"entries > 0): both forms agree; events ms "
               + ", ".join(f"{f} {' / '.join(map(fmt, v))}"
                           for f, v in ms.items())
               + "; device ms " + ", ".join(
                   f"{f} {fmt(d)}" for f, d in summary["device_ms"].items())
               + "; events ms behind a clean-L2 flush " + ", ".join(
                   f"{f} {' / '.join(map(fmt, v))}" for f, v in clean.items())
               + f"; bound {summary['bound_ms']:.6f} ms; floor "
               f"{floor['floor_ms']:.4f} ms (events), "
               f"{fmt(floor['floor_device_ms'])} ms (device)")
        cs.log(f"B8 {group} host: enqueue ms a call " + ", ".join(
            f"{f} {v:.4f}" for f, v in host["host_ms"].items())
            + f", flush {host['flush_host_ms']:.4f}; one traced change call "
            f"{host['traced_call_ms']:.4f} ms wall")
    return results


def capture(st, pairs, hubs, keys):
    """{(kernel, group): [(args, kwargs)]} of this checkout's launches of
    the kernels ``keys``. A dense kernel's adjacency (argument 1) is the
    view its traversal built, kept uncopied."""
    import importlib

    import torch

    from repro_torch.core import bfs, find_slots, multi_bfs
    from repro_torch.index import build_index

    mods = {k: importlib.import_module(f"repro_torch.kernels.{KERNELS[k][0]}"
                                       ".ops") for k in keys}
    originals = {k: getattr(mods[k], KERNELS[k][1]) for k in keys}
    got, tag = {}, {"g": None}

    def recorder(key):
        def rec(*args, **kw):
            got.setdefault((key, tag["g"]), []).append((tuple(
                a if i == 1 else a.clone() for i, a in enumerate(args)), kw))
            return originals[key](*args, **kw)
        return rec

    def slots(ks):
        return find_slots(st, torch.tensor(ks, dtype=torch.int32,
                                           device=st.device))

    for k in keys:
        setattr(mods[k], KERNELS[k][1], recorder(k))
    try:
        sk, dk = slots([p[0] for p in pairs]), slots([p[1] for p in pairs])
        if set(keys) & set(HYBRID):
            tag["g"] = "q64"
            multi_bfs(st, sk, dk, backend="hybrid_cuda")
            tag["g"] = "q1"
            bfs(st, sk[:1], -1, backend="hybrid_cuda")
            tag["g"] = "q1024"
            build_index(st, landmark_slots=hubs, backend="hybrid_cuda")
        if set(keys) & set(DENSE):
            tag["g"] = "q64"
            multi_bfs(st, sk, dk, backend="dense_cuda")
            tag["g"] = "q64c"
            multi_bfs(st, sk, torch.full_like(dk, -1), backend="dense_cuda",
                      parents=False)
            tag["g"] = "q1"
            bfs(st, sk[:1], -1, backend="dense_cuda")
    finally:
        for k in keys:
            setattr(mods[k], KERNELS[k][1], originals[k])
    cs.sync(torch)
    return got, originals


def agree(p_out, c_out, what):
    """new and reach must match; parent where both return one."""
    for i, (x, y) in enumerate(zip(p_out, c_out)):
        if x is None or y is None:
            continue
        if not x.equal(y):
            raise AssertionError(f"{what}: output {i} differs")


def size_of(key, args):
    """Work measure used to pick the largest launches of a group."""
    if key == "B2":
        fw, _, alive, vis = args
        return int((~vis).sum())
    if key in DENSE:   # the active rows: what the dense kernels read
        return int(args[0].reshape(-1, args[0].shape[-1]).any(0).sum())
    return int(args[0].sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    args = ap.parse_args(argv)
    keys = [k for k in args.kernels.split(",") if k]
    unknown = set(keys) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    import torch

    if not torch.cuda.is_available():
        print("ab_bfs_kernels: no CUDA device", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = cs.phase_device(torch)
    libs = build_parent(args.parent, keys)
    rng = np.random.default_rng(args.seed)
    from repro_torch.convert import state_from_numpy

    arrays, _ = cs.graph500_state_arrays(cs.SCALE, cs.CAPACITY, rng)
    st = state_from_numpy(*arrays, device="cuda")
    deg_src = np.flatnonzero(arrays[3][:1 << cs.SCALE] > 0)
    pairs = list(zip(rng.choice(deg_src, cs.QUERIES).tolist(),
                     rng.integers(0, 1 << cs.SCALE, cs.QUERIES).tolist()))
    hubs = cs.hub_slots(st, cs.INDEX_LANDMARKS)
    captured, change = capture(st, pairs, hubs,
                               [k for k in keys if k not in EDGE + ("B8",)])
    timer = cs.Timer(torch)
    results = []
    edge_keys = [k for k in keys if k in EDGE]
    floor = (cs.launch_floor(torch) if edge_keys or "B8" in keys else None)
    if edge_keys:
        results += edge_groups(st, rng, edge_keys, libs, timer, args.reps,
                               floor)
    if "B8" in keys:
        results += join_groups(st, pairs, hubs, libs["B8"], timer, args.reps,
                               floor, rng)
    for (key, group), calls in sorted(captured.items()):
        par = parent_fn(key, libs[key])
        for a, kw in calls:
            p_out = par(*a)
            agree(p_out, change[key](*a, **kw), f"{key} {group}")
            if kw:
                agree(p_out, change[key](*a), f"{key} {group} with parents")
            del p_out
        torch.cuda.synchronize()
        chosen = sorted(calls, key=lambda c: -size_of(key, c[0]))[:args.top]
        rows = []
        for a, kw in chosen:
            def p():
                return par(*a)

            def c():
                return change[key](*a, **kw)
            nbytes, nops, peak = cs._work(torch, key, a, c())
            bound = max(nbytes / cs.HBM_BYTES_PER_S, nops / peak) * 1e3
            t = [timer.ms(f, args.reps) for f in (p, c, c, p)]
            pd, psub = timer.device_ms(p, args.reps)
            cd, csub = timer.device_ms(c, args.reps)
            if kw:   # this checkout's kernel also with parents, as a check

                def cp():
                    return change[key](*a)
                cp_ms = statistics.mean(timer.ms(cp, args.reps)
                                        for _ in range(2))
                cp_dev, _ = timer.device_ms(cp, args.reps)
            else:
                cp_ms = cp_dev = None
            rows.append({"shape": [list(x.shape) for x in a[:2]],
                         "size": size_of(key, a), "bound_ms": bound,
                         "kwargs": {k: str(v) for k, v in kw.items()},
                         "parent_ms": [t[0], t[3]], "change_ms": [t[1], t[2]],
                         "parent_device_ms": pd, "change_device_ms": cd,
                         "change_with_parents_ms": cp_ms,
                         "change_with_parents_device_ms": cp_dev,
                         "parent_sub_ms": psub, "change_sub_ms": csub})
        mean = statistics.mean

        def avg(f):
            vals = [f(r) for r in rows if f(r) is not None]
            return mean(vals) if vals else None

        summary = {
            "kernel": key, "group": group, "launches": len(calls),
            "timed": len(rows),
            "parent_ms": mean(mean(r["parent_ms"]) for r in rows),
            "change_ms": mean(mean(r["change_ms"]) for r in rows),
            "parent_device_ms": avg(lambda r: r["parent_device_ms"]),
            "change_device_ms": avg(lambda r: r["change_device_ms"]),
            "bound_ms": mean(r["bound_ms"] for r in rows),
            "change_with_parents_device_ms": avg(
                lambda r: r["change_with_parents_device_ms"]),
            "parent_sub_ms": {k: mean(r["parent_sub_ms"].get(k, 0.0)
                                      for r in rows)
                              for k in rows[0]["parent_sub_ms"]},
            "change_sub_ms": {k: mean(r["change_sub_ms"].get(k, 0.0)
                                      for r in rows)
                              for k in rows[0]["change_sub_ms"]},
            "rows": rows}
        results.append(summary)
        fmt = "{:.4f}".format

        def subs(d):
            return ", ".join(f"{k} {fmt(v)}" for k, v in d.items())
        pdm, cdm = summary["parent_device_ms"], summary["change_device_ms"]
        cs.log(f"{key} {group}: {len(calls)} launches agree; top "
               f"{len(rows)} events ms parent {fmt(summary['parent_ms'])} / "
               f"change {fmt(summary['change_ms'])}; device ms parent "
               f"{fmt(pdm) if pdm is not None else 'not measured'} "
               f"[{subs(summary['parent_sub_ms'])}] / change "
               f"{fmt(cdm) if cdm is not None else 'not measured'} "
               f"[{subs(summary['change_sub_ms'])}]; bound "
               f"{summary['bound_ms']:.4f} ms"
               + (f"; change with parents device ms "
                  f"{fmt(summary['change_with_parents_device_ms'])}"
                  if summary["change_with_parents_device_ms"] is not None
                  else ""))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"card": card, "results": results}, indent=1))
    cs.log(f"card: {card}; total {time.perf_counter() - t_all:.1f} s; "
           f"written to {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
