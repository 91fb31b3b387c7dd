"""The port's observability layer (repro_torch.obs) against the JAX
package's (repro.obs): the typed registry and a ``StatsView`` under one
call sequence, the declared metric names and kinds (``OBS_METRICS``,
``IngestStats``, ``ServeStats``), the recorder's ``enable`` / ``disable`` /
``clear``, arming by ``REPRO_TRACE`` / ``REPRO_TRACE_PATH`` at import, and
the spans and counters of one traced admission round."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as J
import repro.obs as JO
import repro_torch.core as T
import repro_torch.obs as TO
from repro.runtime.ingest import IngestPool as JPool
from repro.runtime.ingest import IngestStats as JIngestStats
from repro.runtime.serve_loop import ServeStats as JServeStats
from repro_torch.runtime.ingest import IngestPool as TPool
from repro_torch.runtime.ingest import IngestStats as TIngestStats
from repro_torch.obs.trace import PORT_SPANS
from repro_torch.runtime.serve_loop import ServeStats as TServeStats
from torch_jax_isolation import clear_traced_only_jits


def teardown_module():
    # JAX ran under trace.capture() here: leave its traced-only jit
    # caches as a fresh worker has them (tests/torch_jax_isolation.py)
    clear_traced_only_jits()


ROOT = Path(__file__).resolve().parents[1]


def _sequence(obs):
    """One call sequence on a fresh registry and a view over it; returns
    everything observable, errors by type name."""
    reg = obs.MetricsRegistry()

    class Demo(obs.StatsView):
        _PREFIX = "demo"
        _SPEC = {"hits": ("counter", 0), "depth": ("gauge", 0),
                 "wait_s": ("counter", 0.0)}

    view = Demo(reg)
    reg.declare("lat_s", "histogram")
    reg.declare("total", "counter", 5)
    view.hits += 3
    view.depth = 7
    view.wait_s += 0.25
    for x in (0.5, 0.125, 2.0):
        reg.observe("lat_s", x)
    reg.inc("total", 2)
    reg.set("demo.depth", 9)
    reg.declare("total", "counter")          # same kind again: a no-op
    errors = []
    for call in (lambda: reg.declare("total", "gauge"),
                 lambda: reg.declare("x", "timer"),
                 lambda: reg.set("lat_s", 1),
                 lambda: view.missing,
                 lambda: reg.get("undeclared")):
        try:
            call()
            errors.append(None)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            errors.append(type(e).__name__)
    names = reg.names()
    return (reg.snapshot(), view.snapshot(), repr(view), names,
            [reg.kind(n) for n in names], reg.get("lat_s"), errors,
            Demo(reg).snapshot())      # a second view sees the same values


def test_registry_and_stats_view_match_jax_under_one_call_sequence():
    want = _sequence(JO)
    got = _sequence(TO)
    assert got == want
    assert want[6] == ["ValueError", "ValueError", "TypeError",
                       "AttributeError", "KeyError"]


def test_obs_metrics_names_and_kinds_match_jax():
    assert TO.OBS_METRICS == JO.OBS_METRICS
    assert TO.GLOBAL is TO.global_registry()
    assert TO.GLOBAL.names() == JO.GLOBAL.names()
    assert ([TO.GLOBAL.kind(n) for n in TO.GLOBAL.names()]
            == [JO.GLOBAL.kind(n) for n in JO.GLOBAL.names()])
    for name in ("ingest.round_s", "ring.occupancy", "wal.append_s",
                 "ckpt.save_s", "recovery.restore_s", "serve.degraded"):
        assert name in TO.OBS_METRICS


@pytest.mark.parametrize("views", [(JIngestStats, TIngestStats),
                                   (JServeStats, TServeStats)],
                         ids=["IngestStats", "ServeStats"])
def test_stat_views_declare_jax_names_kinds_and_defaults(views):
    jv, tv = views
    assert tv._PREFIX == jv._PREFIX
    assert tv._SPEC == jv._SPEC
    assert tv().registry.snapshot() == jv().registry.snapshot()
    assert issubclass(tv, TO.StatsView)


def test_obs_exports_match_jax():
    assert sorted(TO.__all__) == sorted(JO.__all__)
    for name in TO.__all__:
        assert hasattr(TO, name), name


def _trace_calls(tr):
    """enable / span / counter / disable / clear on one package's trace;
    returns (name, phase, args) of the events seen at each step."""
    def seen():
        return [(e["name"], e["ph"], e.get("args")) for e in
                tr.recorder().events()]

    steps = []
    tr.enable(fresh=True)
    steps.append(tr.enabled())
    with tr.span("a.outer", k=1) as sp:
        with tr.span("a.inner"):
            pass
        sp.set(done=True)
    tr.counter("a.count", 3)
    steps.append(seen())
    tr.disable()
    steps.append(tr.enabled())
    with tr.span("a.ignored"):
        tr.counter("a.ignored", 1)
    steps.append(seen())
    tr.enable()                       # not fresh: the events stay
    steps.append(seen())
    tr.recorder().clear()
    steps.append(seen())
    tr.disable()
    return steps


def test_enable_disable_and_clear_match_jax():
    from repro.obs import trace as jt
    from repro_torch.obs import trace as tt

    was = tt.enabled(), jt.enabled()
    try:
        got, want = _trace_calls(tt), _trace_calls(jt)
    finally:
        (tt.enable if was[0] else tt.disable)()
        (jt.enable if was[1] else jt.disable)()
    assert got == want
    assert got[0] is True and got[2] is False and got[5] == []
    assert [e[0] for e in got[1]] == ["a.inner", "a.outer", "a.count"]


@pytest.mark.parametrize("value,armed", [("1", True), ("off", False)])
def test_repro_trace_env_arms_the_recorder_at_import(tmp_path, value, armed):
    out = tmp_path / "trace.json"
    code = ("import repro_torch.obs.trace as t\n"
            "print(t.enabled())\n"
            "with t.span('env.span', k=1):\n"
            "    pass\n"
            "print(t.save())\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_TRACE": value, "REPRO_TRACE_PATH": str(out)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.split()
    assert lines == [str(armed), str(out)]
    events = json.loads(out.read_text())["traceEvents"]
    assert [e["name"] for e in events] == (["env.span"] if armed else [])


def _traced_pump(M, Pool, tr, **dev):
    pool = Pool(M.make_graph(40, **dev), retain_epochs=4)
    pool.submit("a", [(M.OP_ADD_V, 1), (M.OP_ADD_V, 31), (M.OP_ADD_E, 1, 31)])
    pool.submit("b", [(M.OP_ADD_V, 5)])
    pool.submit("c", [(M.OP_REM_V, 1)])       # exclusive: the next round
    rounds = []
    with tr.capture() as rec:
        for _ in range(2):
            pool.pump()
            rounds.append([(e["name"], e["ph"],
                            {k: v for k, v in e.get("args", {}).items()})
                           for e in rec.events()
                           if e["name"] not in PORT_SPANS])
            rec.clear()
    return rounds


def test_traced_pump_emits_jax_spans_and_counters():
    from repro.obs import trace as jt
    from repro_torch.obs import trace as tt

    want = _traced_pump(J, JPool, jt)
    got = _traced_pump(T, TPool, tt, device="cpu")
    assert got == want
    assert [e[0] for e in want[0]] == ["ingest.admit", "ingest.fused_apply",
                                       "ring.occupancy", "ingest.round"]


def test_only_the_multi_source_bfs_is_traced_as_in_jax():
    from repro.obs import trace as jt
    from repro_torch.convert import state_from_numpy
    from repro_torch.obs import trace as tt

    g, _ = J.apply_ops_fast(J.make_graph(40), J.make_op_batch(
        [(J.OP_ADD_V, k) for k in range(36)]
        + [(J.OP_ADD_E, k, (3 * k + 1) % 36) for k in range(36)]))
    tg = state_from_numpy(*[x.__array__() for x in g], device="cpu")
    got = []
    for M, st, tr in ((J, g, jt), (T, tg, tt)):
        with tr.capture() as rec:
            M.get_path_session(lambda: st, 0, 31)
            single = len(rec.events())
            M.get_paths_session(lambda: st, [(0, 31), (31, 4)])
        got.append((single, [e["name"] for e in rec.events()
                             if e["name"] not in PORT_SPANS]))
    assert got[0] == got[1]
    assert got[1][0] == 0 and "bfs.superstep" in got[1][1]
