"""The readers of the program's own spans (``harness/spans.py`` and the
metrics built on it) on hand-made spans and a device trace with hand-made
device events: the epoch mapping, the innermost open span, device idle
inside a span, the request roots (a pool's ``ingest.round`` among them),
None where the clocks were not matched or there is nothing to read; and
a traced run on the CPU that reports the counter."""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from graphbench.harness import bench, spec  # noqa: E402
from graphbench.harness import spans as sp  # noqa: E402
from graphbench.harness.profile import DeviceTrace  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

EPOCH = 1_000_000_000
NEW = ("serial_lanes_per_batch", "serial_pass_idle_ms", "parent_copy_ms.p50",
       "launch_enqueue_us.p50", "idle_unexplained_pct")


def ev(name, start_us, dur_us, **args):
    e = {"name": name, "ph": "X", "ts": start_us, "dur": dur_us,
         "pid": 1, "tid": 1}
    if args:
        e["args"] = args
    return e


# one batch and one session of part B, on the recorder's clock (us):
#   serve.submit  [0, 100)  > ops.apply [10, 90) > ops.serial_pass [40, 80)
#   session.get_paths [120, 200) > session.to_host [150, 160)
#                                > kernel.launch [130, 132)
EVENTS = [
    ev("serve.submit", 0, 100, lanes=8, seq=1),
    ev("ops.apply", 10, 80, lanes=8, serial_lanes=5, replay=False),
    ev("ops.serial_pass", 40, 40, lanes=5),
    {"name": "ring.occupancy", "ph": "C", "ts": 95, "args": {"value": 1}},
    ev("session.get_paths", 120, 80, pairs=2),
    ev("kernel.launch", 130, 2, package="bfs_step", fn="f"),
    ev("session.to_host", 150, 10, bytes=64),
]


def us(t):
    return EPOCH + t * 1000


def device_trace(busy, offset=0):
    """A DeviceTrace whose device ran in the ``busy`` (start, end) us."""
    tr = DeviceTrace()
    tr.offset_ns = offset
    tr.device = [(us(a), us(b), "k", i) for i, (a, b) in enumerate(busy)]
    return tr


def ctx_for(events, tr, lo=0, hi=200):
    return SimpleNamespace(program_spans=events, trace_b=tr,
                           logs_b=[SimpleNamespace(t0=us(lo), t1=us(hi))])


@pytest.fixture
def clock(monkeypatch):
    monkeypatch.setattr(trace.recorder(), "epoch_ns", EPOCH)


def read(name, ctx):
    return spec.reader("metrics", name)(ctx)


def test_host_spans_map_ts_onto_perf_counter_ns():
    got = sp.host_spans(EVENTS, EPOCH)
    assert [s[2] for s in got] == ["serve.submit", "ops.apply",
                                   "ops.serial_pass", "session.get_paths",
                                   "kernel.launch", "session.to_host"]
    assert got[0][:2] == (us(0), us(100))
    assert got[2][:2] == (us(40), us(80)) and got[2][3] == {"lanes": 5}
    assert [s[2] for s in sp.host_spans(EVENTS, 0, "ops.apply")] == [
        "ops.apply"]
    # an enclosing span sorts before a child that starts with it
    same = sp.host_spans([ev("inner", 5, 1), ev("outer", 5, 9)], 0)
    assert [s[2] for s in same] == ["outer", "inner"]


def test_innermost_names_each_stretch_by_its_deepest_open_span():
    segs = [(a - EPOCH, b - EPOCH, s[2])
            for a, b, s in sp.innermost(sp.host_spans(EVENTS, EPOCH))]
    assert segs == [
        (0, 10_000, "serve.submit"), (10_000, 40_000, "ops.apply"),
        (40_000, 80_000, "ops.serial_pass"), (80_000, 90_000, "ops.apply"),
        (90_000, 100_000, "serve.submit"),
        (120_000, 130_000, "session.get_paths"),
        (130_000, 132_000, "kernel.launch"),
        (132_000, 150_000, "session.get_paths"),
        (150_000, 160_000, "session.to_host"),
        (160_000, 200_000, "session.get_paths")]
    assert sp.innermost([]) == []


def test_overlap_of_ordered_intervals():
    assert sp.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert sp.overlap_ns([(0, 10)], [(10, 20)]) == 0
    assert sp.overlap_ns([], [(0, 5)]) == 0


def test_idle_inside_the_serial_pass_and_idle_no_span_names(clock):
    # busy [0, 50) and [70, 140): idle [50, 70) inside the serial pass,
    # [140, 150) and [160, 200) under session.get_paths, [150, 160) inside
    # session.to_host
    ctx = ctx_for(EVENTS, device_trace([(0, 50), (70, 140)]))
    assert read("serial_pass_idle_ms", ctx) == pytest.approx(0.02)
    assert read("idle_unexplained_pct", ctx) == pytest.approx(
        100 * 50 / 80)
    assert read("serial_lanes_per_batch", ctx) == 5
    assert read("parent_copy_ms.p50", ctx) == pytest.approx(0.01)
    assert read("launch_enqueue_us.p50", ctx) == 2


def test_idle_between_spans_is_unexplained(clock):
    # idle [100, 120): between the batch and the session, under no span
    ctx = ctx_for(EVENTS, device_trace([(0, 100), (120, 200)]))
    assert read("idle_unexplained_pct", ctx) == pytest.approx(100.0)
    assert read("serial_pass_idle_ms", ctx) == 0


def test_a_window_without_a_pool_round_reads_as_before(clock):
    # busy [5, 30), [45, 60), [85, 125), [155, 170): 58 of 105 us of idle
    # under a root or no span; the value the reader gave before
    # ``ingest.round`` became a root
    ctx = ctx_for(EVENTS, device_trace([(5, 30), (45, 60), (85, 125),
                                        (155, 170)]))
    assert read("idle_unexplained_pct", ctx) == pytest.approx(
        55.23809523809524)


# a pool's admission round and a session, on the recorder's clock (us):
#   ingest.round [0, 100) > ingest.admit [5, 15)
#                         > ingest.fused_apply [20, 70) > ops.apply [25, 65)
#   session.get_paths [110, 150) > session.to_host [120, 130)
POOL_EVENTS = [
    ev("ingest.round", 0, 100, admitted=2, applied=2, epoch=3),
    ev("ingest.admit", 5, 10),
    ev("ingest.fused_apply", 20, 50, lanes=8, pad=8, batches=2),
    ev("ops.apply", 25, 40, lanes=8, serial_lanes=0, replay=False),
    ev("session.get_paths", 110, 40, pairs=2),
    ev("session.to_host", 120, 10, bytes=64),
]


@pytest.mark.parametrize("busy,unexplained", [
    # idle [10, 50), [60, 115), [125, 150): 120 us; named: admit 5,
    # fused_apply 5 + 5, ops.apply 25 + 5, to_host 5; unexplained: the
    # round alone 5 + 30, no span 10, get_paths 5 + 20
    ([(0, 10), (50, 60), (115, 125)], 70 / 120),
    # idle [70, 100) under the round alone, [100, 110) under no span
    ([(0, 70), (110, 150)], 1.0),
    # idle [5, 15) inside admission, [20, 25) and [65, 70) inside the
    # fused apply, [30, 60) inside ops.apply: all named
    ([(0, 5), (15, 20), (25, 30), (60, 65), (70, 150)], 0.0),
])
def test_idle_under_the_pool_round_alone_is_unexplained(clock, busy,
                                                         unexplained):
    assert "ingest.round" in sp.ROOTS
    ctx = ctx_for(POOL_EVENTS, device_trace(busy), 0, 150)
    assert read("idle_unexplained_pct", ctx) == pytest.approx(
        100 * unexplained)


@pytest.mark.parametrize("name", ["serial_pass_idle_ms",
                                  "idle_unexplained_pct"])
def test_no_reading_without_matched_clocks(clock, name):
    assert read(name, ctx_for(EVENTS, None)) is None
    assert read(name, ctx_for(EVENTS, device_trace([(0, 50)], None))) is None
    assert read(name, ctx_for(EVENTS, device_trace([]))) is None


@pytest.mark.parametrize("name", ["serial_pass_idle_ms",
                                  "idle_unexplained_pct"])
def test_no_reading_from_a_program_without_a_public_epoch(monkeypatch, name):
    monkeypatch.delattr(trace.recorder(), "epoch_ns")
    assert sp.epoch_ns() is None
    assert read(name, ctx_for(EVENTS, device_trace([(0, 50)]))) is None


@pytest.mark.parametrize("name", NEW)
def test_no_reading_without_the_spans(clock, name):
    roots_only = [e for e in EVENTS if e["name"] in sp.ROOTS]
    want = 100.0 if name == "idle_unexplained_pct" else None
    got = read(name, ctx_for(roots_only, device_trace([(0, 50)])))
    assert got == want


def test_traced_cpu_line_reports_serial_lanes(monkeypatch):
    """As ``test_traced_line_reports_per_layer``: SCALE 8, 512 free slots,
    a churn range of 512 keys."""
    orig = spec.read_json

    def read_json(kind, name):
        d = orig(kind, name)
        if kind == "configs":
            return dict(d, scale=8, capacity=(1 << 8) + 512)
        return dict(d, churn_keys=512)

    monkeypatch.setattr(spec, "read_json", read_json)
    line, _ = bench.run("g500-s18.equal-gp2", 2, 0.6, True, device="cpu",
                        log=lambda m: None)
    m = line["metrics"]
    # on the CPU the device's numbers are not measured; the spans are
    assert {"serial_lanes_per_batch", "parent_copy_ms.p50"} <= set(m)
    assert m["serial_lanes_per_batch"]["value"] > 0
    assert m["serial_lanes_per_batch"]["unit"] == "count"
    assert not {"serial_pass_idle_ms", "idle_unexplained_pct",
                "launch_enqueue_us.p50"} & set(m)
    assert line["correct"]
