"""The port-only spans (``repro_torch.obs.trace.PORT_SPANS``, DESIGN.md
§14): the write path from ``GraphCoServer.submit`` down to the serial
pass, the host side of a GetPath session, and the kernel enqueue. Their
nesting and attributes on known batches, the public clock origin, that
they change no answer and fence nothing, that a disabled recorder holds
no event, and that no name among them is one the JAX package emits."""
import ast
import contextlib
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.ops import _lane_conflicts
from repro_torch.kernels import _build
from repro_torch.kernels.path_walk.ref import CAP as PATH_CAP
from repro_torch.obs import trace
from repro_torch.obs.trace import PORT_SPANS
from repro_torch.runtime.serve_loop import GraphCoServer

ROOT = Path(__file__).resolve().parents[1]
KEYS = 12
EDGES = [(k, (3 * k + 1) % KEYS) for k in range(KEYS)]
# same-key pairs (key 1 twice, key 4 twice), a RemoveVertex, clean lanes
BATCH = [(T.OP_ADD_E, 1, 2), (T.OP_ADD_E, 1, 3), (T.OP_REM_V, 9),
         (T.OP_CON_V, 4), (T.OP_REM_E, 4, 0), (T.OP_ADD_V, 40),
         (T.OP_CON_E, 6, 7), (T.OP_ADD_E, 10, 11)]
PAIRS = [(0, 7), (2, 5), (11, 3), (40, 1)]


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts and ends with the recorder off and empty."""
    was = trace.enabled()
    trace.disable()
    trace.recorder().clear()
    yield
    trace.recorder().clear()
    (trace.enable if was else trace.disable)()


def _server(capacity=32):
    srv = GraphCoServer(capacity=capacity, device="cpu")
    srv.submit([(T.OP_ADD_V, k) for k in range(KEYS)])
    srv.submit([(T.OP_ADD_E, a, b) for a, b in EDGES])
    return srv


def _spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _workload(srv):
    codes = srv.submit(BATCH)
    answers, rounds = srv.get_paths(PAIRS)
    return codes, answers, rounds


def test_traced_submit_nests_the_write_path_and_counts_serial_lanes():
    srv = _server()
    with trace.capture() as rec:
        codes = srv.submit(BATCH)
    ev = rec.events()
    (sub,) = _spans(ev, "serve.submit")
    (app,) = _spans(ev, "ops.apply")
    (ser,) = _spans(ev, "ops.serial_pass")
    assert _inside(app, sub) and _inside(ser, app)
    for name in ("serve.make_batch", "serve.codes_to_host"):
        (s,) = _spans(ev, name)
        assert _inside(s, sub) and not _inside(s, app)
    for name in ("ops.schedule", "ops.clean_pass"):
        (s,) = _spans(ev, name)
        assert _inside(s, app)
    # a bare server's batch lands in its store: no copy
    assert not _spans(ev, "ops.copy")
    lanes = T.make_op_batch(BATCH, device="cpu")
    conflicts = int(_lane_conflicts(lanes).sum())
    assert conflicts == 5      # lanes 0, 1 (key 1), 2 (RemV), 3, 4 (key 4)
    assert app["args"] == {"lanes": len(BATCH), "serial_lanes": conflicts,
                           "replay": False, "in_place": True}
    assert ser["args"] == {"lanes": conflicts, "engine": "host"}
    assert sub["args"] == {"lanes": len(BATCH), "seq": 3}
    assert len(codes) == len(BATCH)


def test_overflowing_batch_reports_a_replay_of_every_lane_and_the_grow():
    srv = _server(capacity=16)       # 12 keys: 4 free slots for 6 AddV
    batch = [(T.OP_ADD_V, 100 + i) for i in range(6)] + [(T.OP_CON_V, 1)]
    with trace.capture() as rec:
        codes = srv.submit(batch)
    ev = rec.events()
    applies = sorted(_spans(ev, "ops.apply"), key=lambda e: e["ts"])
    assert applies[0]["args"] == {"lanes": 7, "serial_lanes": 7,
                                  "replay": True, "in_place": False}
    # the overflowing batch goes to a copy: the pre-batch state is kept
    assert len([s for s in _spans(ev, "ops.copy")
                if _inside(s, applies[0])]) == 1
    (grow,) = _spans(ev, "serve.grow")
    assert grow["args"] == {"capacity": 32}
    assert _inside(applies[1], grow) and not _inside(applies[0], grow)
    assert applies[1]["args"]["replay"] is False
    replay_pass = [s for s in _spans(ev, "ops.serial_pass")
                   if _inside(s, applies[0])]
    assert [s["args"] for s in replay_pass] == [{"lanes": 7,
                                                 "engine": "host"}]
    assert list(codes) == [T.R_TRUE] * 7


def test_traced_get_paths_nests_the_host_copy_with_its_bytes():
    srv = _server()
    # two pairs with a path (0 -> 1 -> 4, and 3 alone) beside PAIRS' none
    pairs = PAIRS + [(0, 4), (3, 3)]
    with trace.capture() as rec:
        answers, rounds = srv.get_paths(pairs)
    ev = rec.events()
    (root,) = _spans(ev, "session.get_paths")
    (mat,) = _spans(ev, "session.materialize")
    (host,) = _spans(ev, "session.to_host")
    (walk,) = _spans(ev, "session.path_walk")
    compares = _spans(ev, "session.compare")
    assert _inside(mat, root) and _inside(host, mat) and _inside(walk, mat)
    assert _inside(host, walk)
    assert len(compares) == rounds - 1
    assert all(_inside(c, root) for c in compares)
    q, v = len(pairs), srv.state.capacity
    # the walk's block int32[Q, 2 + cap]: a pair's found flag, its path's
    # length and its first cap keys, cap = min(PATH_CAP, V); no parent,
    # no slot keys
    assert host["args"] == {"bytes": q * (2 + min(PATH_CAP, v)) * 4}
    assert answers[-2:] == [(True, [0, 1, 4]), (True, [3])]
    assert walk["args"] == {"engine": "host", "hops": 3}
    assert mat["args"] == {"pairs": q}
    assert len(answers) == q


def test_spans_change_no_answer_and_fence_nothing(monkeypatch):
    fences = []
    real_fence = trace.fence

    def counting_fence(x):
        fences.append(1)
        return real_fence(x)

    monkeypatch.setattr(trace, "fence", counting_fence)
    plain = _workload(_server())
    assert not trace.recorder().events()
    with trace.capture() as rec:
        srv = _server()
        fences.clear()
        traced = _workload(srv)
    np.testing.assert_array_equal(traced[0], plain[0])
    assert traced[1:] == plain[1:]
    ev = rec.events()
    # the fences are the collects' and the supersteps' own, none more
    assert len(fences) == (len(_spans(ev, "collect.round"))
                           + len(_spans(ev, "bfs.superstep")))
    # a bare server whose store no caller read grows, and copies it, only
    # on a batch that could overflow (the overflow test holds both spans);
    # it has no ingest pool, so no seat, publish or ring push
    # (tests/test_torch_ingest_seat.py holds those)
    assert {e["name"] for e in ev} >= PORT_SPANS - {
        "kernel.launch", "serve.grow", "ops.copy", "ingest.seat",
        "ingest.publish", "ring.push"}


def test_disabled_recorder_holds_no_event():
    _workload(_server())
    _server(capacity=16).submit([(T.OP_ADD_V, 100 + i) for i in range(6)])
    assert trace.recorder().events() == []


def test_kernel_launch_span_wraps_the_c_call_only(monkeypatch):
    calls = []

    def launcher(*vals):
        calls.append((trace.recorder().events(), vals))
        return 0

    lib = types.SimpleNamespace(fake_launch=launcher,
                                repro_cuda_error_string=lambda code: b"")
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=7))
    with trace.capture() as rec:
        _build.launch("bfs_step", "fake_launch", "cpu", 3, None)
    (span,) = _spans(rec.events(), "kernel.launch")
    assert span["args"] == {"package": "bfs_step", "fn": "fake_launch"}
    assert calls == [([], (3, None, 7))]    # the span closes after the call


def test_export_names_the_clock_origin(tmp_path):
    rec = trace.recorder()
    with trace.capture():
        with trace.span("serve.submit"):
            pass
    doc = json.loads(Path(trace.save(str(tmp_path / "t.json"))).read_text())
    assert doc["otherData"] == {"perf_counter_epoch_ns": rec.epoch_ns}
    (ev,) = doc["traceEvents"]
    assert isinstance(rec.epoch_ns, int) and ev["ts"] >= 0


def _literal_span_names(root: Path) -> set:
    """First arguments of every ``span(...)`` / ``x.span(...)`` call that
    are string literals, over a package's sources."""
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            arg = node.args[0]
            if (called == "span" and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                names.add(arg.value)
    return names


def _string_literals(root: Path) -> set:
    out = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                out.add(node.value)
    return out


def test_port_spans_are_exactly_the_port_only_names():
    port = _literal_span_names(ROOT / "src" / "repro_torch")
    jax_strings = _string_literals(ROOT / "src" / "repro")
    # no JAX string is a port-only name, so the parity filter hides no
    # span of the JAX package
    assert not PORT_SPANS & jax_strings
    assert port - _literal_span_names(ROOT / "src" / "repro") == PORT_SPANS
