"""The port's durable ingest (repro_torch.runtime.recovery, the pool's WAL
and checkpoint cadence, ``GraphCoServer(wal_dir=)`` and the
``durable_serve`` entry point) against the JAX package's
(repro.runtime.recovery, tests/test_recovery.py).

  * For each of the four crash stages, the same durable schedule and fault
    plan run through both packages' harnesses: the WAL bytes and every
    checkpoint file (torn temp dirs included) are identical, the port's
    ``recover`` of the JAX directory and JAX's ``recover`` of the port's
    directory give the same six fields, linearization, ``epoch_log`` and
    ring ``dump``, and ``check_recovery_equivalent`` holds on the port's
    trace, with each stage's own effect.
  * The rest of tests/test_recovery.py's dense tests on the port: a clean
    round trip, idempotence, truncation behind a checkpoint, gap and
    divergence errors, ``resume_pool``, a seeded crash sweep, degraded
    mode, the restart budget, the heartbeat, server state bits.
  * The round order append (fsync) -> publish -> ack -> checkpoint, and a
    ``wal-append`` crash publishing and acking nothing.
  * ``durable_serve`` killed by SIGKILL and recovered, on the CPU.
  * ``recover``, ``restore`` and the harness default to the card.
"""
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.runtime.ingest as ingest
from repro.obs import trace as jtrace
from repro.obs.metrics import GLOBAL as JGLOBAL
from repro.runtime.fault import FaultInjector as JFault
from repro.runtime.recovery import recover as jrecover
from repro.runtime.serve_loop import GraphCoServer as JServer
import repro.testing.schedules as jsched
from repro.testing.schedules import run_schedule as jrun
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.graph import (R_EDGE_ADDED, R_RECOVERING, R_TRUE,
                                    RESULT_NAMES, make_graph)
from repro_torch.obs import trace as ttrace
from repro_torch.obs.metrics import GLOBAL as TGLOBAL
from repro_torch.runtime.fault import (FailurePolicy, FaultInjector,
                                       Heartbeat, SimulatedCrash)
from repro_torch.runtime.recovery import (GraphCheckpointer, RecoveryError,
                                          recover, resume_pool)
from repro_torch.runtime.serve_loop import GraphCoServer
from repro_torch.runtime.wal import WalRecord, WriteAheadLog
import repro_torch.testing.schedules as tsched
from repro_torch.testing.schedules import (check_recovery_equivalent,
                                           check_trace_linearizable,
                                           host_fields)
from repro_torch.testing.schedules import run_schedule as trun

ROOT = Path(__file__).resolve().parents[1]
CPU = {"device": "cpu"}
STAGES = ["wal-append", "wal-fsync", "ckpt-mid-write", "post-publish-pre-ack"]
# probes of each stage let pass before the kill: every stage fires after
# at least one published cadence checkpoint (ckpt-mid-write on the second)
DELAYS = {"wal-append": 5, "wal-fsync": 4, "ckpt-mid-write": 1,
          "post-publish-pre-ack": 6}


def _schedule(seed, M=tsched):
    """A schedule from package ``M``'s harness (both draw the same)."""
    rng = random.Random(seed)
    progs = M.gen_client_programs(rng, clients=3, batches_per_client=4,
                                  max_lanes=3, conflict_rate=0.5)
    return M.random_schedule(random.Random(seed + 1), progs)


def _crash_trace(stage, *, seed=7, delay=0, ckpt_every=2, durable_dir=None,
                 capacity=8, run=trun, fault=FaultInjector):
    fi = fault(plan=[("*", stage)], delays={("*", stage): delay})
    if run is trun:
        return run(_schedule(seed), capacity=capacity, fault=fi,
                   durable_dir=durable_dir, ckpt_every=ckpt_every, **CPU)
    return run(_schedule(seed, jsched), capacity=capacity, fault=fi,
               durable_dir=durable_dir, ckpt_every=ckpt_every)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_dirs(jdir: Path, tdir: Path):
    jf, tf = _files(jdir), _files(tdir)
    assert sorted(tf) == sorted(jf)
    for name, jb in jf.items():
        if name.endswith("manifest.json"):
            jm, tm = json.loads(jb), json.loads(tf[name])
            jm.pop("time"), tm.pop("time")
            assert tm == jm, name
        else:
            assert tf[name] == jb, name


def _jax_fields(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_same_recovered(t, j):
    """A port ``Recovered`` equals a JAX one: six fields, linearization,
    epoch_log, ticket counter, ring dump bytes."""
    assert (t.epoch, t.linearization, t.epoch_log, t.next_batch_id,
            t.ckpt_step, t.replayed_rounds, t.skipped_records) == (
        j.epoch, j.linearization, j.epoch_log, j.next_batch_id,
        j.ckpt_step, j.replayed_rounds, j.skipped_records)
    got, want = host_fields(t.state), _jax_fields(j.state)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    tl, tm = t.ring.dump()
    jl, jm = j.ring.dump()
    assert tm == jm and len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- the four stages against JAX ----------------------------------------------
@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax_and_recovers_across_packages(tmp_path, stage):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jt = _crash_trace(stage, delay=DELAYS[stage], durable_dir=str(jdir),
                      run=jrun, fault=JFault)
    tt = _crash_trace(stage, delay=DELAYS[stage], durable_dir=str(tdir))
    assert tt.crash is not None and tt.crash.stage == stage
    assert (tt.crash.published_epoch, tt.crash.linearization,
            tt.crash.acked) == (jt.crash.published_epoch,
                                jt.crash.linearization, jt.crash.acked)
    # the same bytes on disk: WAL (torn tail included) and checkpoints
    # (torn temp dir included), before any recovery opens them
    _assert_same_dirs(jdir, tdir)
    assert tt.pool.stats.ckpt_saves >= 1
    if stage == "ckpt-mid-write":
        assert any(n.startswith(".tmp_step_")
                   for n in os.listdir(tdir / "ckpt"))

    t_of_j = recover(str(jdir / "ckpt"), str(jdir / "wal.log"), capacity=8,
                     **CPU)
    j_of_t = jrecover(str(tdir / "ckpt"), str(tdir / "wal.log"), capacity=8)
    _assert_same_recovered(t_of_j, j_of_t)
    rec = check_recovery_equivalent(tt)
    _assert_same_recovered(rec, j_of_t)

    crash = tt.crash
    if stage == "wal-append":
        # the torn frame was dropped and the round never published
        assert rec.epoch == crash.published_epoch
        assert rec.epoch == crash.epoch_attempted - 1
    elif stage == "wal-fsync":
        # the durable, unpublished round comes back: one epoch gained
        assert rec.epoch == crash.published_epoch + 1
        assert crash.epoch_attempted == rec.epoch
    elif stage == "ckpt-mid-write":
        # the previous published step plus the WAL tail
        assert rec.ckpt_step is not None
        assert rec.ckpt_step < crash.epoch_attempted
        assert rec.replayed_rounds == rec.epoch - rec.ckpt_step > 0
        assert rec.epoch == crash.published_epoch
    else:
        assert rec.epoch == crash.published_epoch


def test_durable_spans_and_metrics_match_jax(tmp_path):
    """A traced durable run and its recovery record the same spans in the
    same order as the JAX package's, and move the same histograms."""
    names = ("wal.append_s", "ckpt.save_s", "recovery.restore_s")
    got = []
    for run, rec_fn, fault, tr, reg, sub in (
            (jrun, jrecover, JFault, jtrace, JGLOBAL, "jax"),
            (trun, recover, FaultInjector, ttrace, TGLOBAL, "port")):
        d = tmp_path / sub
        before = {n: reg.get(n)["count"] for n in names}
        with tr.capture() as rec:
            _crash_trace("post-publish-pre-ack", delay=3,
                         durable_dir=str(d), run=run, fault=fault)
            rec_fn(str(d / "ckpt"), str(d / "wal.log"), capacity=8,
                   **(CPU if run is trun else {}))
        spans = [e["name"] for e in rec.events()
                 if e["name"].startswith(("wal.", "ckpt.", "recovery.",
                                          "ingest.round"))]
        got.append((spans, {n: reg.get(n)["count"] - before[n]
                            for n in names}))
    assert got[1] == got[0]
    assert got[1][1] == {"wal.append_s": 4, "ckpt.save_s": 1,
                         "recovery.restore_s": 1}


# -- tests/test_recovery.py's dense tests on the port ------------------------
def test_recovery_without_fault_roundtrips(tmp_path):
    tr = _crash_trace("none", durable_dir=str(tmp_path), ckpt_every=3)
    assert tr.crash is None
    check_trace_linearizable(tr)
    rec = recover(GraphCheckpointer(str(tmp_path / "ckpt")),
                  WriteAheadLog(str(tmp_path / "wal.log")),
                  capacity=tr.capacity, retain_epochs=tr.pool.ring.retain,
                  **CPU)
    assert rec.epoch == tr.pool.epoch
    assert rec.linearization == list(tr.pool.linearization)
    assert set(rec.parts) == {"ckpt_load", "to_device", "ring_load",
                              "replay"}
    got, want = host_fields(rec.state), host_fields(tr.pool._head)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_recovery_is_idempotent(tmp_path):
    tr = _crash_trace("post-publish-pre-ack", delay=2,
                      durable_dir=str(tmp_path))
    rec1 = check_recovery_equivalent(tr)
    rec2 = check_recovery_equivalent(tr)
    assert rec1.epoch == rec2.epoch
    assert rec1.linearization == rec2.linearization
    for f, a in host_fields(rec1.state).items():
        np.testing.assert_array_equal(a, host_fields(rec2.state)[f])


def test_checkpoint_truncates_wal_behind_it(tmp_path):
    tr = _crash_trace("post-publish-pre-ack", delay=4, ckpt_every=2,
                      durable_dir=str(tmp_path))
    assert tr.crash is not None
    ckpt = GraphCheckpointer(str(tmp_path / "ckpt"))
    step = ckpt.latest_step()
    assert step is not None and step > 0
    wal = WriteAheadLog(str(tmp_path / "wal.log"))
    assert all(r.epoch > step for r in wal.records())
    rec = recover(ckpt, wal, capacity=tr.capacity,
                  retain_epochs=tr.pool.ring.retain, **CPU)
    assert rec.ckpt_step == step
    assert rec.replayed_rounds == sum(1 for _ in wal.records())


def _rec(epoch, ops, results=None):
    results = results if results is not None else [R_TRUE] * len(ops)
    return WalRecord(epoch=epoch, ops=[list(o) for o in ops], pad=len(ops),
                     clients=["c0"], batch_ids=[epoch - 1], results=results,
                     lanes=len(ops))


def test_wal_gap_is_a_recovery_error(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.log"))
    wal.append(_rec(1, [[1, 3, 0, 0]]))
    wal.append(_rec(3, [[1, 4, 0, 0]]))            # epoch 2 missing
    with pytest.raises(RecoveryError, match="gap"):
        recover(None, wal, capacity=8, **CPU)


def test_replay_divergence_is_a_recovery_error(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path)
    # claim AddE(5, 6) succeeded: on an empty graph both endpoints are
    # missing, so an honest replay disagrees with the stored result code
    wal.append(_rec(1, [[4, 5, 6, 0]], results=[int(R_EDGE_ADDED)]))
    with pytest.raises(RecoveryError, match="divergence"):
        recover(None, wal, capacity=8, **CPU)
    rec = recover(None, WriteAheadLog(path), capacity=8,
                  verify_results=False, **CPU)
    assert rec.epoch == 1


def test_replay_runs_apply_ops_fast_on_opcodes_past_hasedge(tmp_path):
    """Opcode 7 answers R_FALSE in ``apply_ops_fast`` (``apply_ops`` clips
    it to HasEdge): replay must take the fast engine's answer."""
    wal = WriteAheadLog(str(tmp_path / "wal.log"))
    wal.append(_rec(1, [[1, 3], [1, 4], [4, 3, 4]],
                    results=[R_TRUE, R_TRUE, int(R_EDGE_ADDED)]))
    wal.append(_rec(2, [[7, 3, 4]], results=[0]))
    for M, kw in ((recover, CPU), (jrecover, {})):
        assert M(None, str(tmp_path / "wal.log"), capacity=8, **kw).epoch == 2


def test_resume_pool_continues_publishing(tmp_path):
    tr = _crash_trace("post-publish-pre-ack", delay=1,
                      durable_dir=str(tmp_path))
    rec = check_recovery_equivalent(tr)
    pool = resume_pool(rec)
    t = pool.submit("c9", [(1, 900), (1, 901), (4, 900, 901)])
    pool.flush()
    assert t.status == "applied"
    assert pool.epoch == rec.epoch + 1
    assert t.batch_id == rec.next_batch_id      # id space continues
    assert pool.linearization == rec.linearization + [t.batch_id]
    assert pool.state_at(rec.epoch) is not None   # the ring continues too


@pytest.mark.parametrize("seed", range(4))
def test_chaos_recovery_sweep_dense(tmp_path, seed):
    rng = random.Random(100 + seed)
    for trial in range(4):
        stage = rng.choice(STAGES)
        tr = _crash_trace(stage, seed=200 + 10 * seed + trial,
                          delay=rng.randrange(0, 6),
                          ckpt_every=rng.choice([0, 2, 3]),
                          durable_dir=str(tmp_path / f"t{trial}"))
        if tr.crash is None:
            check_trace_linearizable(tr)        # armed too late: clean run
            continue
        check_recovery_equivalent(tr)


# -- the round order and the wal-append crash --------------------------------
def _recording_pool(tmp_path, monkeypatch, events, **kw):
    class LoggedTicket(ingest.Ticket):
        def __setattr__(self, name, value):
            if name == "status" and value == "applied":
                events.append(("ack", self.batch_id))
            super().__setattr__(name, value)

    class RecordingWal(WriteAheadLog):
        def append(self, record):
            super().append(record)
            events.append(("fsync", record.epoch, tuple(record.batch_ids)))

    class RecordingCkpt(GraphCheckpointer):
        def save_graph(self, *, epoch, **kw):
            events.append(("ckpt", epoch))
            super().save_graph(epoch=epoch, **kw)

    monkeypatch.setattr(ingest, "Ticket", LoggedTicket)
    pool = ingest.IngestPool(
        make_graph(40, device="cpu"),
        wal=RecordingWal(str(tmp_path / "wal.log")),
        ckpt=RecordingCkpt(str(tmp_path / "ckpt")), ckpt_every=2, **kw)
    publish = pool._publish

    def recorded_publish(state):
        epoch = publish(state)
        events.append(("publish", epoch))
        return epoch

    pool._publish = recorded_publish
    return pool


def test_round_order_is_append_publish_ack_checkpoint(tmp_path, monkeypatch):
    events = []
    pool = _recording_pool(tmp_path, monkeypatch, events)
    rng = np.random.default_rng(3)
    for _ in range(5):
        for c in range(3):
            keys = rng.integers(10 * c, 10 * c + 10, 4).tolist()
            pool.submit(f"c{c}", [(1, keys[0]), (1, keys[1]),
                                  (4, keys[2], keys[3])])
        pool.pump()
    pool.flush()
    rounds = [i for i, e in enumerate(events) if e[0] == "fsync"]
    assert len(rounds) == pool.epoch >= 5
    assert sum(e[0] == "ckpt" for e in events) == pool.epoch // 2
    for n, i in enumerate(rounds):
        end = rounds[n + 1] if n + 1 < len(rounds) else len(events)
        _, epoch, bids = events[i]
        kinds = [e[0] for e in events[i:end]]
        want = ["fsync", "publish"] + ["ack"] * len(bids)
        if epoch % 2 == 0:
            want.append("ckpt")
        assert kinds == want, (epoch, events[i:end])
        assert events[i + 1] == ("publish", epoch)
        assert sorted(e[1] for e in events[i + 2:i + 2 + len(bids)]) == \
            sorted(bids)
    assert pool.stats.wal_records == pool.epoch
    assert len(pool.wal) == pool.epoch % 2       # truncated behind each ckpt


def test_a_wal_append_crash_publishes_and_acks_nothing(tmp_path, monkeypatch):
    events = []
    fi = FaultInjector(plan=[("*", "wal-append")],
                       delays={("*", "wal-append"): 1})
    pool = _recording_pool(tmp_path, monkeypatch, events, fault=fi)
    first = pool.submit("c0", [(1, 1), (1, 2)])
    pool.pump()
    events.clear()
    dying = [pool.submit("c0", [(4, 1, 2)]), pool.submit("c1", [(1, 9)])]
    with pytest.raises(SimulatedCrash) as err:
        pool.pump()
    assert err.value.stage == "wal-append" and err.value.epoch == 2
    assert events == []                      # no fsync, publish, ack, ckpt
    assert pool.epoch == 1 and pool.linearization == [first.batch_id]
    assert [t.status for t in dying] == ["queued", "queued"]
    pool.wal.close()
    reopened = WriteAheadLog(str(tmp_path / "wal.log"))
    assert reopened.stats.torn_drops > 0 and len(reopened) == 1


# -- degraded-mode serving -----------------------------------------------------
def _warm_server(tmp_path, *, server=GraphCoServer, **kw):
    dev = CPU if server is GraphCoServer else {}
    srv = server(capacity=32, ingest=True, wal_dir=str(tmp_path),
                 ckpt_every=kw.pop("ckpt_every", 0), **dev, **kw)
    srv.submit_client("c0", [(1, 0), (1, 1), (1, 2)])
    srv.submit_client("c1", [(4, 0, 1), (4, 1, 2)])
    srv.flush()
    return srv


def test_degraded_mode_pins_reads_and_rejects_writes(tmp_path):
    srv = _warm_server(tmp_path)
    fi = FaultInjector()
    srv.pool.fault = fi
    fi.plan.append(("*", "post-publish-pre-ack"))
    with pytest.raises(SimulatedCrash):
        srv.submit_client("c0", [(1, 7)])
        srv.flush()
    srv.enter_degraded()
    pinned_epoch = srv._pinned[0]
    res = srv.submit([(1, 8), (1, 9)])
    assert list(res) == [R_RECOVERING, R_RECOVERING]
    assert RESULT_NAMES[int(res[0])] == "RECOVERING"
    t = srv.submit_client("c2", [(1, 10)])
    assert t.status == "rejected" and t.batch_id == -1
    assert list(t.results) == [R_RECOVERING]
    assert srv.rejected_writes == 2
    r = srv.get_reach([(0, 2)])
    assert r.found == [True] and r.degraded is True
    assert srv.degraded_reads >= 1 and srv._pinned[0] == pinned_epoch
    m = srv.get_metrics()
    assert m["server.degraded"] == 1 and m["server.rejected_writes"] == 2
    # recover: the crashed-but-published round is re-derived, writes resume
    srv.recover_now()
    assert not srv.degraded and srv.recoveries == 1
    assert srv.pool.epoch == pinned_epoch
    assert list(srv.submit([(1, 8)])) == [R_TRUE]


def test_handle_crash_respects_restart_budget(tmp_path):
    srv = _warm_server(tmp_path, failure_policy=FailurePolicy(
        max_restarts=2, backoff_s=0.25))
    assert srv.handle_crash() == 0.25
    assert srv.handle_crash() == 0.5
    assert srv.recoveries == 2 and not srv.degraded
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        srv.handle_crash()
    assert srv.degraded


def test_heartbeat_timeout_triggers_recovery(tmp_path):
    srv = _warm_server(tmp_path, heartbeat=Heartbeat(timeout_s=5.0),
                       failure_policy=FailurePolicy(max_restarts=3,
                                                    backoff_s=0.0))
    srv.worker_tick("ingest", now=100.0)
    assert srv.check_health(now=104.0) == []
    assert srv.check_health(now=106.0) == ["ingest"]
    assert srv.recoveries == 1 and not srv.degraded
    assert srv.check_health(now=107.0) == []
    assert srv.recoveries == 1


def test_recovery_preserves_server_state_bits(tmp_path):
    """Degrade and recover with a cadence checkpoint behind a WAL tail: all
    six fields, the linearization, the resolved tickets and the index stamp
    survive, and the JAX server on the same calls ends in the same bits."""
    out = []
    for server, sub in ((GraphCoServer, "port"), (JServer, "jax")):
        srv = _warm_server(tmp_path / sub, server=server, ckpt_every=2,
                           index=True)
        srv.index_tick()
        srv.submit_client("c2", [(1, 5), (4, 2, 5)])
        srv.flush()
        before = {f: np.asarray(getattr(srv.state, f)).copy()
                  for f in srv.state._fields}
        tickets = dict(srv.pool.tickets)
        lin, stamp = list(srv.pool.linearization), srv.pool.index_stamp
        assert srv.pool.stats.ckpt_saves == 1 and len(srv.pool.wal) == 1
        srv.enter_degraded()
        srv.recover_now()
        assert list(srv.pool.linearization) == lin
        assert srv.pool.index_stamp == stamp == {"epoch": 2, "refreshes": 1}
        assert all(srv.pool.tickets[b] is t for b, t in tickets.items())
        for f, want in before.items():
            np.testing.assert_array_equal(np.asarray(getattr(srv.state, f)),
                                          want)
        assert srv.get_reach([(0, 5)]).found == [True]
        out.append(before)
    for f in out[1]:
        a = out[0][f].view(np.uint32) if out[0][f].dtype == np.int32 and \
            out[1][f].dtype == np.uint32 else out[0][f]
        np.testing.assert_array_equal(a, out[1][f], err_msg=f)


# -- the entry point, killed for real -----------------------------------------
def test_durable_serve_sigkill_roundtrip(tmp_path):
    """``python -m repro_torch.launch.durable_serve`` is SIGKILLed mid-run;
    the restarted process recovers every acknowledged round and serves
    past the crash epoch."""
    wal_dir = str(tmp_path / "durable")
    report = str(tmp_path / "report.jsonl")
    base = [sys.executable, "-m", "repro_torch.launch.durable_serve",
            "--wal-dir", wal_dir, "--report", report, "--ckpt-every", "3",
            "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    p = subprocess.run(base + ["--steps", "10", "--crash-at-step", "6"],
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode == -9, (p.returncode, p.stderr)
    p2 = subprocess.run(base + ["--recover", "--steps", "3"], env=env,
                        capture_output=True, text=True, timeout=120)
    assert p2.returncode == 0, p2.stderr

    lines = [json.loads(line) for line in open(report)]
    acked, last_epoch = set(), 0
    for rec in lines:
        if rec["type"] == "recovered":
            break
        acked.update(rec["acked"])
        last_epoch = rec["epoch"]
    recovered = next(r for r in lines if r["type"] == "recovered")
    done = next(r for r in lines if r["type"] == "done")
    assert len(acked) == 21
    assert acked <= set(recovered["linearization"])       # zero acked loss
    assert recovered["epoch"] >= last_epoch
    assert done["epoch"] > recovered["epoch"]             # serving resumed
    assert set(recovered["linearization"]) <= set(done["linearization"])


# -- the card by default -------------------------------------------------------
def test_recover_and_restore_default_to_the_card(tmp_path):
    ck = Checkpointer(str(tmp_path / "plain"))
    ck.save(1, [torch.ones(2)], blocking=True)
    tr = trun(_schedule(3), capacity=16, durable_dir=str(tmp_path / "d"),
              ckpt_every=2, **CPU)
    gck = GraphCheckpointer(str(tmp_path / "d" / "ckpt"))
    if torch.cuda.is_available():
        assert recover(gck, None).state.vkey.is_cuda
        assert ck.restore([torch.ones(2)])[0][0].is_cuda
        assert gck.restore_graph()[0].adj_packed.is_cuda
        return
    for call in (lambda: recover(None, None, capacity=8),
                 lambda: recover(gck, str(tmp_path / "d" / "wal.log")),
                 lambda: ck.restore([torch.ones(2)]),
                 lambda: gck.restore_graph(),
                 lambda: trun(_schedule(3), capacity=8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # recover(mesh=) is ported: the directory recovers onto 8 CPU row
    # blocks of 2 rows as JAX's recover(mesh=) does onto its mesh (six
    # fields, linearization, ring dump); a mesh that is no GraphMesh
    # raises TypeError
    from repro.core import partition as jpart
    from repro.core.distributed import make_graph_mesh as jax_mesh
    from repro_torch.core.distributed import make_graph_mesh

    d = tmp_path / "d"
    trec = recover(gck, str(d / "wal.log"),
                   mesh=make_graph_mesh(["cpu"], shards=8))
    jrec = jrecover(str(d / "ckpt"), str(d / "wal.log"), mesh=jax_mesh())
    jrec.state = jpart.unshard(jrec.state)
    _assert_same_recovered(trec, jrec)
    assert trec.state.num_shards == 8 and trec.replayed_rounds > 0
    with pytest.raises(TypeError) as err:
        recover(None, None, mesh=object(), **CPU)
    assert "A10" not in str(err.value)
    assert recover(gck, None, **CPU).epoch == gck.latest_step() > 0
    assert tr.crash is None
