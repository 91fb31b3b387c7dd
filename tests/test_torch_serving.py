"""The port's ``GraphCoServer`` (repro_torch.runtime.serve_loop) against the
JAX package's (repro.runtime.serve_loop): one call sequence through every
graph endpoint (``submit`` with and without the pool, ``submit_client`` /
``pump`` / ``flush``, ``get_path(s)``, ``get_reach``, ``get_reach_counts``,
``get_reach_at`` retained and evicted, ``epoch_diff``, ``index_tick``,
degraded mode through ``enter_degraded``, ``handle_crash``,
``check_health`` and the restart budget) gives equal answers, and
``get_metrics`` has the same keys and values apart from wall seconds.
Also ``reach_session(ring=...)`` pinned at a retained epoch and
``index_fresh_at``, the same call sequence with ``mesh=`` (8 CPU row
blocks against JAX's mesh), the default device and the import boundary."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.index.freshness as JF
import repro_torch.core as T
import repro_torch.index.freshness as TF
from repro.core.distributed import make_graph_mesh as jax_mesh
from repro.obs import trace as jtrace
from repro.obs.metrics import GLOBAL as JGLOBAL
from repro.runtime import fault as jfault
from repro.runtime.ingest import IngestPool as JPool
from repro.runtime.serve_loop import GraphCoServer as JServer
from repro_torch.core.distributed import make_graph_mesh
from repro_torch.obs import trace as ttrace
from repro_torch.obs.metrics import GLOBAL as TGLOBAL
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.ingest import IngestPool as TPool
from repro_torch.runtime.serve_loop import GraphCoServer as TServer

ROOT = Path(__file__).resolve().parents[1]
WALL = ("ingest.wait_s", "ingest.wait_max_s")


def _plain(x):
    """A comparable value of any endpoint's answer (dataclasses of either
    package, tensors, arrays, named tuples)."""
    if dataclasses.is_dataclass(x):
        fields = [f.name for f in dataclasses.fields(x)
                  if not f.name.startswith("_")
                  and f.name not in ("enqueue_t", "wait_s")]   # wall clock
        return (type(x).__name__,) + tuple(_plain(getattr(x, f))
                                           for f in fields)
    if isinstance(x, torch.Tensor):
        return _plain(x.numpy())
    if hasattr(x, "__array__") and not isinstance(x, (list, tuple)):
        return np.asarray(x).tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(y) for y in x]
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def _catch(fn):
    try:
        return ("ok", _plain(fn()))
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return ("raised", type(e).__name__, str(e))


def _serve(M, Server, fault, **dev):
    """The call sequence; returns (answers, server)."""
    hb = fault.Heartbeat(timeout_s=5.0)
    policy = fault.FailurePolicy(max_restarts=2, backoff_s=0.5)
    s = Server(capacity=48, ingest=True, index=True, index_landmarks=6,
               retain_epochs=5, max_coalesce_lanes=16, heartbeat=hb,
               failure_policy=policy, **dev)
    out = []
    keys = list(range(34)) + [39, 47]
    edges = [(k, (3 * k + 1) % 34) for k in range(34)]
    edges += [(31, 39), (39, 47), (47, 2), (5, 31)]
    out.append(s.submit([(M.OP_ADD_V, k) for k in keys]))
    out.append(s.submit([(M.OP_ADD_E, a, b) for a, b in edges]))
    out.append(s.get_reach([(0, 47), (31, 2)]))        # no index yet
    out.append(s.index_tick())
    out.append(s.index_tick())                          # fresh: nothing
    tickets = []
    for r in range(4):
        for c in range(4):
            k = 7 * c + r
            ops = [(M.OP_ADD_E, k % 34, (k + 11) % 34),
                   (M.OP_REM_E, (k + 5) % 34, (3 * k + 16) % 34)]
            if c == 3 and r == 2:
                ops = [(M.OP_REM_V, 20), (M.OP_ADD_V, 20)]   # exclusive
            tickets.append(s.submit_client(f"c{c}", ops))
        out.append(s.pump())
    out.append(s.flush())
    out.append([(t.batch_id, t.status, t.results, t.epoch, t.retries)
                for t in tickets])
    out.append(s.epoch_window())
    pairs = [(0, 47), (31, 2), (47, 31), (5, 39), (12, 40), (2, 2)]
    out.append(s.get_path(0, 47))
    out.append(s.get_path(31, 2))
    out.append(s.get_paths(pairs))
    out.append(s.get_reach(pairs))                      # stale index
    out.append(s.get_reach_counts([0, 31, 47, 40]))
    out.append(s.index_tick())                          # refresh
    out.append(s.get_reach(pairs))                      # fresh again
    out.append(s.get_reach_counts([0, 31, 47]))
    lo, hi = s.epoch_window()
    out.append(s.get_reach_at(pairs, hi - 1))
    out.append(s.get_reach_at(pairs, lo))
    out.append(s.get_reach_at(pairs, lo - 1))           # evicted
    out.append(s.epoch_diff(lo, hi))
    out.append(s.epoch_diff(hi, lo + 1))
    out.append(s.epoch_diff(lo - 1, hi))                # evicted
    # degraded mode: pinned reads, R_RECOVERING writes
    s.enter_degraded()
    out.append(s.submit([(M.OP_ADD_V, 45)]))
    out.append(s.submit_client("c0", [(M.OP_ADD_V, 46)]))
    out.append(s.get_path(0, 47))
    out.append(s.get_paths(pairs[:2]))
    res = s.get_reach(pairs[:3])
    out.append((res, res.degraded))
    out.append(s.get_reach_counts([0]))
    s.recover_now()
    out.append(s.submit([(M.OP_ADD_V, 45)]))
    # heartbeat suspects and the restart budget
    s.worker_tick("ingest", now=0.0)
    out.append(s.check_health(now=2.0))
    out.append(s.check_health(now=10.0))
    out.append(_catch(s.handle_crash))
    out.append(_catch(s.handle_crash))                  # budget exhausted
    out.append((s.degraded, s.state.capacity))
    # the bare server: auto-grow replay without a pool
    bare = Server(capacity=8, **dev)
    out.append(bare.submit([(M.OP_ADD_V, k) for k in range(12)]
                           + [(M.OP_ADD_E, 11, 0)]))
    out.append((bare.grow_events, bare.state.capacity, bare.on_conflict))
    out.append(bare.get_paths([(11, 0)]))
    out.append(_catch(lambda: bare.epoch_window()))
    out.append(_catch(lambda: bare.get_reach_at([(0, 1)], 0)))
    out.append(_catch(lambda: bare.submit_client("c", [(M.OP_ADD_V, 1)])))
    return [_plain(x) for x in out], s


def _global_delta(after, before, registry):
    """Tracing metrics moved by the sequence: counter deltas, histogram
    sample counts, gauge values."""
    out = {}
    for name in registry.names():
        kind = registry.kind(name)
        if kind == "histogram":
            out[name] = after[name]["count"] - before[name]["count"]
        elif kind == "counter":
            out[name] = after[name] - before[name]
        else:
            out[name] = after[name]
    return out


def test_server_endpoints_and_metrics_match_jax():
    runs = []
    for M, Server, fault, tr, reg, dev in (
            (J, JServer, jfault, jtrace, JGLOBAL, {}),
            (T, TServer, tfault, ttrace, TGLOBAL, {"device": "cpu"})):
        before = reg.snapshot()
        with tr.capture():
            answers, s = _serve(M, Server, fault, **dev)
        metrics = s.get_metrics()
        runs.append((answers, metrics,
                     _global_delta(reg.snapshot(), before, reg), s))
    (ja, jm, jg, js), (ta, tm, tg, ts) = runs
    for i, (a, b) in enumerate(zip(ta, ja)):
        assert a == b, f"answer {i}: port {a} != jax {b}"
    assert len(ta) == len(ja)
    assert sorted(tm) == sorted(jm)
    local = [k for k in jm if k not in TGLOBAL.names() and k not in WALL]
    assert {k: tm[k] for k in local} == {k: jm[k] for k in local}
    assert tg == jg
    assert jg["ingest.round_s"] > 0 and jg["bfs.supersteps"] > 0
    assert jg["ring.resolve_depth"] > 0 and jg["index.query_s"] > 0
    assert tm["server.recoveries"] == 0 and tm["server.rejected_writes"] == 2
    assert ts.state.vkey.device.type == "cpu"


def _pinned(M, Pool, I, **dev):
    """A stale-at-head index served pinned at a retained epoch (a round
    commits inside the session's state fetch), and one made stale before
    the session (must not pin)."""
    pool = Pool(M.make_graph(40, **dev), retain_epochs=6)
    pool.submit("load", [(M.OP_ADD_V, k) for k in range(36)]
                + [(M.OP_ADD_E, k, (5 * k + 3) % 36) for k in range(36)]
                + [(M.OP_ADD_E, 31, 35), (M.OP_ADD_E, 35, 31)])
    pool.flush()
    index = I.build_index(pool.snapshot(), 5)
    pairs = [(0, 31), (31, 7), (4, 35), (35, 0), (12, 30), (33, 33)]
    out = [I.index_fresh_at(index, pool.ring), I.index_fresh_at(index, None)]

    def racing_fetch():
        pool.submit("m", [(M.OP_ADD_E, 2, 9)])
        pool.flush()
        return pool.snapshot()

    res = I.reach_session(racing_fetch, index, pairs, on_conflict="epoch",
                          fetch_epoch=pool.snapshot_epoch, ring=pool.ring)
    out.append(res)
    out.append(I.index_fresh_at(index, pool.ring))
    # stale before the session: the admitted epoch is past the pin
    res = I.reach_session(pool.snapshot, index, pairs, on_conflict="epoch",
                          fetch_epoch=pool.snapshot_epoch, ring=pool.ring)
    out.append(res)
    # the pin left the window
    for r in range(6):
        pool.submit("m", [(M.OP_ADD_E, r, 20 + r)])
        pool.flush()
    out.append(I.index_fresh_at(index, pool.ring))
    return [_plain(x) for x in out]


def test_ring_pinned_reach_session_and_index_fresh_at_match_jax():
    want = _pinned(J, JPool, JF)
    got = _pinned(T, TPool, TF, device="cpu")
    assert got == want
    pinned, stale = want[2], want[4]
    # (name, found, from_index, fellback, stale, rounds, pinned_epoch, ...)
    assert pinned[6] == want[0] == 1 and pinned[2] > 0
    assert stale[4] is True and stale[2] == 0
    assert want[1] is None and want[5] is None


def test_ring_validation_span_and_metric_are_kept():
    got = []
    for M, Pool, I, tr, reg, dev in (
            (J, JPool, JF, jtrace, JGLOBAL, {}),
            (T, TPool, TF, ttrace, TGLOBAL, {"device": "cpu"})):
        before = reg.get("index.ring_validate_s")["count"]
        with tr.capture() as rec:
            _pinned(M, Pool, I, **dev)
        got.append(([e["name"] for e in rec.events()],
                    reg.get("index.ring_validate_s")["count"] - before))
    assert got[0] == got[1]
    assert "index.ring_validate" in got[1][0] and got[1][1] == 2


@pytest.mark.parametrize("kw", [{"mesh": object()}], ids=["mesh"])
def test_server_parts_that_wait_for_later_slices_raise(kw):
    # ``mesh=`` is ported: the whole call sequence on 8 CPU row blocks (6
    # rows each; the bare server's 1, then 2 after its grow) answers as
    # JAX's server on its mesh, with the same metrics; the sharded BFS
    # moves the exchange bytes by JAX's formula, which counts every shard
    # (8 here, 1 on JAX's mesh). A mesh that is no GraphMesh raises.
    runs = []
    for M, Server, fault, tr, reg, mesh in (
            (J, JServer, jfault, jtrace, JGLOBAL, jax_mesh()),
            (T, TServer, tfault, ttrace, TGLOBAL,
             make_graph_mesh(["cpu"], shards=8))):
        before = reg.snapshot()
        with tr.capture():
            answers, s = _serve(M, Server, fault, mesh=mesh)
        runs.append((answers, s.get_metrics(),
                     _global_delta(reg.snapshot(), before, reg), s))
    (ja, jm, jg, _), (ta, tm, tg, ts) = runs
    for i, (a, b) in enumerate(zip(ta, ja)):
        assert a == b, f"answer {i}: port {a} != jax {b}"
    assert len(ta) == len(ja)
    assert isinstance(ts.state, T.ShardedGraphState)
    local = [k for k in jm if k not in TGLOBAL.names() and k not in WALL]
    assert {k: tm[k] for k in local} == {k: jm[k] for k in local}
    xb = "bfs.exchange_bytes"
    assert tg[xb] == 8 * jg[xb] > 0
    assert {k: v for k, v in tg.items() if k != xb} == \
        {k: v for k, v in jg.items() if k != xb}
    with pytest.raises(TypeError) as err:
        TServer(capacity=8, ingest=True, device="cpu", **kw)
    assert "A10" not in str(err.value)


def test_server_pool_and_ring_default_to_the_card():
    if torch.cuda.is_available():
        s = TServer(capacity=64, ingest=True)
        assert s.state.vkey.is_cuda and s.pool.ring._latest.vkey.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TServer(capacity=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.EpochRing.load(*J.EpochRing(2).dump())
    pool = TPool(T.make_graph(40, device="cpu"))
    pool.submit("c", [(T.OP_ADD_V, 31)])
    pool.flush()
    assert pool.snapshot().vkey.device.type == "cpu"


def test_serving_modules_load_no_jax():
    code = ("import sys\n"
            "import repro_torch.runtime\n"
            "assert 'repro_torch.runtime.ingest' not in sys.modules\n"
            "import repro_torch.obs, repro_torch.core.epochs\n"
            "import repro_torch.runtime.fault, repro_torch.runtime.ingest\n"
            "import repro_torch.runtime.serve_loop\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
