#!/usr/bin/env python3
"""Time the port's BFS kernels B1, B2, B3, B6 and B7 against a parent
commit's, on one NVIDIA GPU, in the same process.

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
}
HYBRID = ("B1", "B2", "B3")
DENSE = ("B6", "B7")


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

    return {"B1": b1, "B2": b2, "B3": b3, "B6": b6, "B7": b7}[key]


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
    captured, change = capture(st, pairs, hubs, keys)
    timer = cs.Timer(torch)
    results = []
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
