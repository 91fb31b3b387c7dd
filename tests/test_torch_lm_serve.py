"""The port's ``serve()`` (repro_torch.runtime.serve_loop) against the JAX
package's (repro.runtime.serve_loop) on the CPU: olmo-1b's smoke model on
the same converted params, the same prompts and equally seeded traffic
callables, in the traffic modes of tests/test_system.py and
tests/test_serving_stats.py: a mutator with lone-pair queries, batched
queries over every container shape, and ``clients=`` on
``GraphCoServer(ingest=True, index=True)`` (with a planned crash that
``pump`` hands to ``handle_crash``). In each: the generated tokens, every
``ServeStats`` field but the wall clock, ``get_metrics`` outside timings,
the tracing metrics and the span names are equal. Also the ``clients=``
``RuntimeError`` without a pool, per-serve deltas across two calls,
``repro_torch.launch.serve`` printing JAX's launcher's graph-side lines
for the default arch and for each MoE, SSM and RG-LRU config, and both
launchers failing on whisper-base for want of ``frames``."""
import itertools
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import get_config as jax_config
from repro.launch import serve as jax_launch
from repro.models.model import build_model as jax_build
from repro.obs import trace as jtrace
from repro.obs.metrics import GLOBAL as JGLOBAL
from repro.runtime import fault as jfault
from repro.runtime.serve_loop import GraphCoServer as JServer
from repro.runtime.serve_loop import serve as jax_serve
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch
from repro_torch.models.model import build_model
from repro_torch.obs import trace as ttrace
from repro_torch.obs.metrics import GLOBAL as TGLOBAL
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.serve_loop import GraphCoServer as TServer
from repro_torch.runtime.serve_loop import serve
from torch_jax_isolation import clear_traced_only_jits


def teardown_module():
    # JAX ran under trace.capture() here: leave its traced-only jit
    # caches as a fresh worker has them (tests/torch_jax_isolation.py)
    clear_traced_only_jits()


ARCH = "olmo-1b"
WALL_STATS = ("wall_s",)
WALL_METRICS = ("ingest.wait_s", "ingest.wait_max_s", "ingest.wal_append_s")


def _models():
    jcfg = jax_config(ARCH).smoke()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(get_config(ARCH).smoke(),
                              jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, (jm, jp), (build_model(get_config(ARCH).smoke()), tp)


CFG, JAX_LM, PORT_LM = _models()
SIDES = (("jax", J, JServer, jax_serve, JAX_LM, jfault, jtrace, JGLOBAL, {}),
         ("port", T, TServer, serve, PORT_LM, tfault, ttrace, TGLOBAL,
          {"device": "cpu"}))


def _fake_clock():
    counter = itertools.count()
    return lambda: float(next(counter))


def _global_delta(after, before, registry):
    """Tracing metrics moved by a run: counter deltas, histogram sample
    counts, and {gauge: (value after, set to a new value)} (a gauge is
    process-global and keeps what earlier tests left)."""
    out, gauges = {}, {}
    for name in registry.names():
        kind = registry.kind(name)
        if kind == "histogram":
            out[name] = after[name]["count"] - before[name]["count"]
        elif kind == "counter":
            out[name] = after[name] - before[name]
        else:
            gauges[name] = (after[name], after[name] != before[name])
    return out, gauges


def _run(mode, tmp_path=None):
    """Run ``mode`` through both packages; returns one record per side."""
    runs = []
    for name, M, Server, serve_fn, (model, params), fault, tr, reg, dev \
            in SIDES:
        rng = np.random.default_rng(0)
        srv, prompts, kw = mode(M, Server, fault, rng, dev,
                                tmp_path / name if tmp_path else None)
        before = reg.snapshot()
        with tr.capture() as rec:
            out, stats = serve_fn(model, params, prompts, **kw, graph=srv)
            spans = [e["name"] for e in rec.events() if e.get("ph") == "X"
                     and e["name"] not in ttrace.PORT_SPANS]
        runs.append(dict(out=out, stats=stats.snapshot(),
                         metrics=srv.get_metrics(), spans=spans,
                         tracing=_global_delta(reg.snapshot(), before, reg),
                         srv=srv))
    return runs


def _same(runs, wall_stats=WALL_STATS):
    j, t = runs
    np.testing.assert_array_equal(t["out"], j["out"])
    assert t["out"].dtype == np.int32
    assert sorted(t["stats"]) == sorted(j["stats"])
    keep = [k for k in j["stats"] if k not in wall_stats]
    assert {k: t["stats"][k] for k in keep} == {k: j["stats"][k]
                                                for k in keep}
    assert sorted(t["metrics"]) == sorted(j["metrics"])
    local = [k for k in j["metrics"]
             if k not in TGLOBAL.names() and k not in WALL_METRICS]
    assert {k: t["metrics"][k] for k in local} == {k: j["metrics"][k]
                                                   for k in local}
    (tmoved, tgauges), (jmoved, jgauges) = t["tracing"], j["tracing"]
    assert tmoved == jmoved
    assert sorted(tgauges) == sorted(jgauges)
    changed = [k for k in jgauges if jgauges[k][1] or tgauges[k][1]]
    assert {k: tgauges[k][0] for k in changed} == {k: jgauges[k][0]
                                                   for k in changed}
    assert t["spans"] == j["spans"]
    assert {"serve.session", "serve.prefill", "serve.decode_step"} <= set(
        t["spans"])
    return t


def _mutator_mode(M, Server, fault, rng, dev, _):
    """tests/test_system.py::test_serve_with_graph_coserving."""
    prompts = rng.integers(0, CFG.vocab, (2, 8)).astype(np.int32)
    graph = Server(capacity=64, **dev)
    graph.submit([(M.OP_ADD_V, k) for k in range(8)])

    def mutator(i):
        u, v = rng.integers(0, 8, 2)
        return [(M.OP_ADD_E, int(u), int(v))]

    def queries(i):
        return (0, 5) if i % 3 == 0 else None

    return graph, prompts, dict(max_new_tokens=6, cache_len=32,
                                mutator=mutator, query_stream=queries)


def _batched_mode(M, Server, fault, rng, dev, _):
    """tests/test_system.py::test_serve_with_batched_graph_queries: every
    container shape a query stream may return."""
    prompts = rng.integers(0, CFG.vocab, (1, 8)).astype(np.int32)
    graph = Server(capacity=64, **dev)
    graph.submit([(M.OP_ADD_V, k) for k in range(8)])
    graph.submit([(M.OP_ADD_E, 0, 1), (M.OP_ADD_E, 1, 5)])
    streams = {
        0: [(0, 5), (5, 0), (2, 2)],          # list of pairs
        1: ((0, 1), (1, 5)),                  # tuple of pairs
        2: np.array([3, 4]),                  # single pair as ndarray
        3: np.array([[0, 5], [1, 1]]),        # ndarray batch
        4: [],                                # empty batch: no traffic
    }
    return graph, prompts, dict(max_new_tokens=6, cache_len=32,
                                query_stream=lambda i: streams.get(i))


A_OPS = [(1, 1), (1, 2), (4, 1, 2)]           # opcodes as in repro.core
B_OPS = [(1, 11), (1, 12), (4, 11, 12)]
C_OPS = [(1, 5), (4, 1, 12)]


def _client_mode(M, Server, fault, rng, dev, wal_dir, crash=False):
    """``clients=`` with ingest and index: tests/test_serving_stats.py's
    scripted A/B-coalesce, C-retry step, then 3 random tenants a step;
    queries alternate a batch through the index and a lone pair."""
    assert (M.OP_ADD_V, M.OP_ADD_E) == (1, 4)
    prompts = rng.integers(0, CFG.vocab, (2, 8)).astype(np.int32)
    kw = {}
    if crash:
        kw = dict(wal_dir=str(wal_dir), ckpt_every=3,
                  fault=fault.FaultInjector(
                      plan=[("*", "post-publish-pre-ack")],
                      delays={("*", "post-publish-pre-ack"): 3}),
                  failure_policy=fault.FailurePolicy(max_restarts=2))
    srv = Server(capacity=32, ingest=True, index=True, index_landmarks=4,
                 retain_epochs=6, **kw, **dev)
    srv.pool.clock = _fake_clock()
    srv.submit([(M.OP_ADD_V, k) for k in range(16)])

    def clients(step):
        if step == 0:
            return [("A", A_OPS), ("B", B_OPS), ("C", C_OPS)]
        return [(f"t{c}", [(M.OP_ADD_E, *(int(x) for x in
                                          rng.integers(0, 16, 2)))])
                for c in range(3)]

    def queries(step):
        pairs = rng.integers(0, 16, (5, 2))
        return pairs if step % 2 == 0 else (int(pairs[0, 0]),
                                            int(pairs[0, 1]))

    return srv, prompts, dict(max_new_tokens=6, cache_len=16,
                              clients=clients, query_stream=queries)


def test_serve_with_a_mutator_matches_jax():
    t = _same(_run(_mutator_mode))
    assert t["stats"]["decode_tokens"] == 12
    assert t["stats"]["getpath_calls"] == 2 and t["stats"]["graph_ops"] > 0


def test_serve_with_batched_queries_matches_jax():
    t = _same(_run(_batched_mode))
    assert t["stats"]["getpath_calls"] == 3 + 2 + 1 + 2
    assert t["stats"]["getpath_rounds"] / t["stats"]["getpath_calls"] == 2.0
    res, rounds = t["srv"].get_paths([(0, 5), (5, 0), (99, 0)])
    assert rounds == 2
    assert res == [(True, [0, 1, 5]), (False, []), (False, [])]


def test_serve_with_clients_ingest_and_index_matches_jax():
    t = _same(_run(_client_mode))
    s = t["stats"]
    assert s["ingest_batches"] == 3 + 5 * 3 and s["ingest_retries"] >= 1
    assert s["index_refreshes"] > 0 and s["index_hits"] > 0
    assert s["getpath_calls"] == 3 * 5 + 3
    assert t["srv"].get_paths([(1, 12)])[0][0] == (True, [1, 12])


def test_serve_hands_a_pump_crash_to_handle_crash_as_jax(tmp_path):
    """A planned post-publish-pre-ack kill in the 4th admission round:
    ``pump`` raises ``SimulatedCrash``, ``serve`` recovers the pool from
    its WAL and decodes on. The recovered pool runs on the wall clock, so
    its waits are left out."""
    runs = _run(lambda *a: _client_mode(*a, crash=True), tmp_path)
    t = _same(runs, wall_stats=("wall_s", "ingest_wait_s",
                                "ingest_wait_max_s"))
    assert t["stats"]["recoveries"] == 1
    assert t["srv"].failure_policy.restarts == 1


def test_serve_rejects_clients_without_an_ingest_pool():
    errors = []
    for _, _, Server, serve_fn, _, _, _, _, dev in SIDES:
        with pytest.raises(RuntimeError, match="ingest=True") as err:
            serve_fn(None, None, np.zeros((1, 4), np.int32),
                     max_new_tokens=1, cache_len=8, graph=Server(
                         capacity=8, **dev), clients=lambda i: [])
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_serve_stats_are_per_call_deltas_as_in_jax():
    """tests/test_serving_stats.py::test_serve_stats_deltas_reset_between_
    serve_calls on both packages: a grow in the first call does not leak
    into the second call's stats."""
    got = []
    for _, M, Server, serve_fn, (model, params), _, _, _, dev in SIDES:
        srv = Server(capacity=4, ingest=True, **dev)
        srv.pool.clock = _fake_clock()
        prompts = np.zeros((1, 8), np.int32)

        def growing(step):
            return [("A", [(M.OP_ADD_V, k) for k in range(6)])] if step == 0 \
                else []

        o1, s1 = serve_fn(model, params, prompts, max_new_tokens=2,
                          cache_len=16, graph=srv, clients=growing)
        o2, s2 = serve_fn(model, params, prompts, max_new_tokens=2,
                          cache_len=16, graph=srv, clients=lambda i: [])
        got.append([(o.tolist(), {k: v for k, v in s.snapshot().items()
                                  if k != "wall_s"})
                    for o, s in ((o1, s1), (o2, s2))])
    assert got[1] == got[0]
    (_, s1), (_, s2) = got[1]
    assert s1["grow_events"] >= 1 and s1["ingest_batches"] == 1
    assert s2["grow_events"] == 0 and s2["ingest_batches"] == 0
    assert s2["ingest_epochs"] == 0


def _graph_lines(text: str) -> list[str]:
    """The launcher's lines without the decode wall clock and rate."""
    lines = text.strip().splitlines()
    assert lines[0].startswith("decoded ")
    return [lines[0].split("; ", 1)[1]] + lines[1:]


def test_launcher_prints_the_jax_launchers_graph_lines(capsys, monkeypatch):
    assert launch.main(["--device", "cpu", "--ingest"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve", "--ingest"])
    jax_launch.main()
    want = capsys.readouterr().out
    assert _graph_lines(port) == _graph_lines(want)
    assert len(_graph_lines(port)) == 7
    assert "time-travel: epoch" in port and "stale-index reach" in port


def test_launcher_defaults_to_the_card_without_a_fallback():
    if torch.cuda.is_available():
        assert launch.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--ingest"])


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m", "olmoe-1b-7b",
                                  "mamba2-780m", "recurrentgemma-9b"))
def test_launcher_serves_each_decoder_family_as_jax(arch, capsys,
                                                    monkeypatch):
    """``--arch`` of each MoE, SSM and RG-LRU config (smoke width) on the
    CPU: the port's launcher prints the JAX launcher's graph-side lines."""
    assert launch.main(["--arch", arch, "--device", "cpu", "--smoke",
                        "--ingest"]) == 0
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke",
                                      "--ingest"])
    jax_launch.main()
    want = capsys.readouterr().out
    assert _graph_lines(port) == _graph_lines(want)
    assert port.startswith("decoded 128 tokens")


def test_both_launchers_fail_on_whisper_for_want_of_frames(monkeypatch):
    """JAX's ``EncDecModel.prefill`` needs ``frames``, which ``serve()``
    never passes; the port adds no frames path JAX lacks, and fails as it
    does."""
    with pytest.raises(KeyError, match="frames"):
        launch.main(["--arch", "whisper-base", "--device", "cpu", "--smoke"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper-base",
                                      "--smoke"])
    with pytest.raises(KeyError, match="frames"):
        jax_launch.main()
