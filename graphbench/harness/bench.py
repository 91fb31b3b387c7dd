"""One run of one cell: set-up, the measured window, the check, the line.

``run`` is what ``graphbench/run.py`` calls. With ``trace=0`` the window
measures the cell's end-to-end metrics and nothing else runs beside the
program. With ``trace=1`` its first 27% (6 s at most) runs under
``torch.profiler`` (the device's busy and idle time, the device time
inside each ``submit``, the harness's spans, the window's memory peak),
its next 13% (3 s at most) under the program's own tracing
(``repro_torch.obs.trace``) with the traversal kernels' launches recorded
for their bounds, and the rest as in an untraced run. Each part's numbers come from that part
alone, so none reads another's overhead: the device's numbers from the
first, the program's spans and the launches from the second, the
harness's host spans from the untraced rest. The profiler's record stays
small enough to read in seconds.
"""
from __future__ import annotations

import bisect
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from graphbench.harness import check, loop, spec
from graphbench.harness.profile import DeviceTrace
from graphbench.harness.roofline import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
WARM_ROUNDS = 4          # set-up's rounds, at least one of each call
SAMPLE_SESSIONS = 12     # GetPath sessions of the window the check samples
PART_A = 0.27            # share of a traced window under the profiler,
PART_A_MAX_S = 6.0       # at most this long
PART_B = 0.13            # share under the program's tracing, after it,
PART_B_MAX_S = 3.0       # at most this long


def process_start_s() -> float:
    """Seconds since this process began (from /proc where it exists)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        since_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return since_boot - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` unless given) whose top-level name
    is JAX's, Flax's, the JAX package's or the old benchmarks'."""
    loaded = sys.modules if modules is None else modules
    tops = {name.split(".")[0] for name in list(loaded)}
    return sorted(tops & set(FORBIDDEN))


def warm_rounds(mix: dict) -> int:
    """Enough rounds that each of the mix's batches comes twice."""
    sub = mix.get("submit")
    ex = (mix.get("clients") or {}).get("exclusive")
    every = int(sub["every"]) if sub else int(ex["every"]) if ex else 0
    return max(WARM_ROUNDS, 2 * every)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", make_server=None, final_sets=None, log=print):
    """(result line dict, checks {name: (value, limit)}). ``make_server``
    and ``final_sets`` stand in for the program (the control and the
    tests); ``log`` takes the lines for standard error."""
    import torch

    bench = spec.load_benchmark()
    entry = spec.cell(bench, workload)
    cfg = spec.read_json("configs", entry["config"])
    mix = spec.read_json("traffic", entry["traffic"])
    on_card = torch.device(device).type == "cuda"

    t_build = process_start_s()
    s = loop.build(cfg, mix, seed, device, make_server)
    _sync(device)
    t_warm = process_start_s()
    took = loop.warm(s, warm_rounds(mix))
    _sync(device)
    setup_s = process_start_s()
    log(f"set-up: {t_build:.1f} s to start, {t_warm - t_build:.1f} s graph "
        f"({s.graph.edges} distinct arcs) and store, {setup_s - t_warm:.1f} "
        f"s warm rounds and a compaction ("
        + ", ".join(f"{x:.2f}" for x in took) + f" s); {setup_s:.1f} s")
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    ctx = SimpleNamespace(cfg=cfg, mix=mix, entry=entry, setup_s=setup_s,
                          trace_a=None, trace_b=None, launches=[],
                          program_spans=[], logs_b=[], logs_c=[])
    if not trace:
        logs = loop.run_for(s, seconds)
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    else:
        ctx.trace_a = DeviceTrace() if on_card else None
        if ctx.trace_a:
            ctx.trace_a.start()
        part_a = min(seconds * PART_A, PART_A_MAX_S)
        part_b = min(seconds * PART_B, PART_B_MAX_S)
        logs = loop.run_for(s, part_a)
        if ctx.trace_a:
            ctx.trace_a.stop()
            log(ctx.trace_a.summary("profiled part"))
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
        ctx.logs_b, ctx.program_spans, ctx.launches, ctx.trace_b = _part_b(
            s, part_b, on_card)
        _log_b(ctx, log)
        ctx.logs_c = loop.run_for(s, seconds - part_a - part_b)
    ctx.logs = logs
    ctx.t0, ctx.t1 = logs[0].t0, logs[-1].t1
    ctx.window_peak_bytes = window_peak

    log(stationarity(logs + ctx.logs_c if trace else logs))
    log(tenths(logs if not trace else ctx.logs_c))

    # the check: the batches still awaited, the program's final store,
    # then the reference's replay
    s.drained = loop.pump(s)
    t_check = time.perf_counter()
    grows = s.server.get_metrics().get("server.grow_events", 0)
    sets = (final_sets or _program_sets)(s)
    later = ctx.logs_b + ctx.logs_c
    window = {lg.index for lg in logs + later}
    numbers, answers = check.compare(
        s, window, SAMPLE_SESSIONS,
        np.random.default_rng(loop.seed_seq(seed, 2)), sets, grows, device)
    limits = check.LIMITS | check.CLIENT_LIMITS
    checks = {k: (v, limits[k]) for k, v in numbers.items()}
    correct = all(v <= lim for v, lim in checks.values())
    log(f"checked: {sum(lg.lanes for lg in s.rounds)} lanes of "
        f"{len(s.rounds)} rounds, {answers} GetPath answers, in "
        f"{time.perf_counter() - t_check:.1f} s")

    kind = "per_layer" if trace else "end_to_end"
    folder = "metrics" if trace else "endtoend"
    metrics = {}
    for m in spec.metrics_of(bench, kind, workload):
        value = spec.reader(folder, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(lg.ops for lg in logs + later)
    failed = sum(_failed(lg) for lg in logs + later)
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": dev}
    if trace and ctx.trace_a is not None:
        lo, hi = ctx.t0, ctx.t1
        if ctx.trace_a.offset_ns is None and ctx.trace_a.device:
            # clocks unmatched: the span of the device events stands in
            lo = ctx.trace_a.device[0][0]
            hi = max(e[1] for e in ctx.trace_a.device)
        dev["busy_s"] = ctx.trace_a.busy_ns(lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        line["breakdown"] = breakdown(ctx)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line, checks


def stationarity(logs: list) -> str:
    """The window's rounds, and the median round wall of its first and its
    last tenth: equal where the work does not drift."""
    walls = [(lg.t1 - lg.t0) / 1e6 for lg in logs]
    k = max(1, len(walls) // 10)
    return (f"window: {len(walls)} rounds, {sum(lg.compacted for lg in logs)}"
            f" compactions; median round {np.median(walls):.2f} ms, "
            f"{np.median(walls[:k]):.2f} ms in the first tenth, "
            f"{np.median(walls[-k:]):.2f} ms in the last")


def tenths(logs: list) -> str:
    """Where a window drifts: for each tenth of its untraced rounds, the
    median round wall and the caller thread's CPU ms a round. A wall that
    grows at the same CPU is time off the core; the CUDA runtime spins
    while it waits for the device, so a wait on the device counts as CPU."""
    k = max(1, len(logs) // 10)
    walls, cpus = [], []
    for i in range(0, k * 10, k):
        part = logs[i:i + k]
        if len(part) < 2:
            break
        walls.append(np.median([(lg.t1 - lg.t0) / 1e6 for lg in part]))
        cpus.append((part[-1].cpu - part[0].cpu) / 1e6 / (len(part) - 1))
    return ("tenths: median round ms " + " ".join(f"{w:.1f}" for w in walls)
            + "; caller CPU ms a round " + " ".join(f"{c:.1f}" for c in cpus))


def _program_sets(s):
    """The final store's sets, then the server and its store freed."""
    import gc

    import torch

    state = s.server.state
    out = check.store_sets(state, s.graph.n + int(s.mix["churn_keys"]))
    del state
    s.server = s.compact = None       # the compaction closure holds it too
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _failed(lg) -> int:
    """Lanes refused (TABLE FULL, RECOVERING), lanes of a client batch
    that was not applied (aborted, rejected, never landed) and queries of
    a session that ran out of collects."""
    bad = 0
    if lg.codes is not None:
        bad += int(np.isin(np.asarray(lg.codes), (7, 9)).sum())
    for tk in lg.tickets or ():
        if tk.status != "applied":
            bad += len(tk.ops)
        elif tk.codes is not None:
            bad += int(np.isin(tk.codes, (7, 9)).sum())
    if lg.answers is not None and lg.collects >= 64:
        bad += lg.queries
    return bad


def _part_b(s, seconds: float, on_card: bool):
    """The traced window's second part: the program's spans, and the
    traversal kernels' launches with their bounds and device times."""
    from repro_torch.obs import trace as ptrace

    rec = Recorder() if on_card else None
    dtrace = DeviceTrace() if on_card else None
    if rec:
        rec.install()
        dtrace.start()
    try:
        with ptrace.capture() as program:
            logs = loop.run_for(s, seconds)
            spans = program.events()
    finally:
        if rec:
            dtrace.stop()
            rec.remove()
    return logs, spans, (rec.launches if rec else []), dtrace


def _log_b(ctx, log) -> None:
    tr = ctx.trace_b
    if tr is None:
        return
    joined = [tr.launched_ns(a, b) for _, a, b, _, _ in ctx.launches]
    within = [tr.busy_ns(a, b) for _, a, b, _, _ in ctx.launches]
    log(tr.summary("traced part") + f"; {len(ctx.launches)} traversal "
        f"launches recorded, {sum(x > 0 for x in joined)} joined to their "
        f"device work: {sum(joined) / 1e6:.3f} ms by correlation, "
        f"{sum(within) / 1e6:.3f} ms inside their host intervals")


def breakdown(ctx) -> dict:
    """The 10 device operations that took most time in the profiled part,
    and its idle time by what the harness was doing on the host then."""
    tr = ctx.trace_a
    ops = sorted(tr.by_name(ctx.t0, ctx.t1).items(), key=lambda kv: -kv[1])
    starts = [lg.t0 for lg in ctx.logs]
    idle: dict = {}
    for a, b in tr.idle_gaps(ctx.t0, ctx.t1):
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        lg = ctx.logs[i] if i >= 0 else None
        if lg is None or mid >= lg.t1:
            what = "between rounds"
        elif lg.submit and lg.submit[0] <= mid < lg.submit[1]:
            what = "submit"
        elif lg.session and lg.session[0] <= mid < lg.session[1]:
            what = "get_paths"
        else:
            what = "the caller, between calls"
        idle[what] = idle.get(what, 0.0) + (b - a) / 1e9
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, v] for n, v in ops[:10]],
            "idle_gaps": [[n, v] for n, v in gaps[:10]]}
