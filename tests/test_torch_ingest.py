"""The port's ingest pool (repro_torch.runtime.ingest) against the JAX
package's (repro.runtime.ingest), driven through the same schedules of
``repro.testing.schedules``: seeded random interleavings with head reads,
hostile epoch-resolved reads and time-travel reads, every interleaving of
a small program, ``FaultInjector`` plans at ``admit`` and ``apply`` and the
``wal-append`` / ``wal-fsync`` / ``post-publish-pre-ack`` crash stages
without a WAL, grow-and-replay from capacity 8, and exclusive RemoveVertex
batches. Compared: every ticket (status, results, epoch, retries), the
linearization, ``epoch_log``, the reads, the stats apart from the
``wait*_s`` wall times, the ring window and the final six arrays. Also: 4
threads submitting at once, checked by serial replay through the port's
oracle; and ``wal=`` / ``ckpt=`` / ``mesh=`` raise."""
import random
import threading

import numpy as np
import pytest

import repro_torch.core as T
from repro.runtime.fault import FaultInjector as JFault
from repro.testing.schedules import (enumerate_interleavings,
                                     gen_client_programs, random_schedule,
                                     run_schedule)
from repro_torch.convert import state_to_numpy
from repro_torch.core.graph import to_networkx_like
from repro_torch.core.snapshot import get_paths_session
from repro_torch.runtime.fault import FaultInjector as TFault
from repro_torch.runtime.fault import SimulatedCrash
from repro_torch.runtime.ingest import (IngestPool, _next_pow2,
                                        batch_footprint)

WALL = ("wait_s", "wait_max_s")


def _norm(op):
    op = tuple(int(x) for x in op) + (-1,) * (4 - len(op))
    return op[:4]


def _hostile_epoch_read(pool, pairs, max_rounds=3):
    """The port side of ``schedules._hostile_epoch_read``: every state
    fetch first commits a round that bumps each query source's ecnt, so
    the session must resolve at a pinned published epoch."""
    srcs = sorted({int(k) for k, _ in pairs})
    last_epoch = [pool.epoch]

    def hostile_fetch():
        fresh = 9000 + pool.stats.submitted
        pool.submit("_hostile", [_norm((T.OP_ADD_V, fresh))]
                    + [_norm((T.OP_ADD_E, k, fresh)) for k in srcs])
        pool.pump()
        epoch, snap = pool.snapshot_epoch()
        last_epoch[0] = epoch
        return snap

    st: dict = {}
    out, _ = get_paths_session(hostile_fetch, pairs, max_rounds=max_rounds,
                               on_conflict="epoch",
                               fetch_epoch=pool.snapshot_epoch, stats=st)
    epoch = st["epoch"] if st["epoch"] is not None else last_epoch[0]
    return (int(epoch), list(pairs), out, "epoch", bool(st["starved"]))


def run_port(schedule, *, capacity=32, fault=None, **kw):
    """``schedules.run_schedule`` step for step on the port's pool (CPU);
    returns (pool, reads, crash (stage, epoch) or None)."""
    pool = IngestPool(T.make_graph(capacity, device="cpu"), fault=fault,
                      **kw)
    reads = []
    try:
        for step in schedule.steps:
            if step[0] == "submit":
                pool.submit(step[1], step[2])
            elif step[0] == "pump":
                pool.pump()
            elif step[0] == "flush":
                pool.flush()
            elif step[0] == "read":
                epoch, snap = pool.snapshot_epoch()
                out, _ = get_paths_session(lambda: snap, step[1])
                reads.append((epoch, list(step[1]), out, "head", False))
            elif step[0] == "read_epoch":
                reads.append(_hostile_epoch_read(pool, step[1]))
            elif step[0] == "tt":
                lo, hi = pool.epoch_window()
                epoch = max(lo, hi - int(step[1]))
                snap = pool.state_at(epoch)
                out, _ = get_paths_session(lambda: snap, step[2])
                reads.append((epoch, list(step[2]), out, "tt", False))
            else:
                raise ValueError(f"unknown step {step!r}")
        pool.flush()
    except SimulatedCrash as exc:
        return pool, reads, (exc.stage, exc.epoch)
    return pool, reads, None


def _tickets(pool):
    return {bid: (t.client_id, t.status, None if t.results is None
                  else [int(x) for x in t.results], t.epoch, t.retries,
                  t.exclusive, sorted(t.footprint))
            for bid, t in pool.tickets.items()}


def _stats(pool):
    return {k: v for k, v in pool.stats.snapshot().items() if k not in WALL}


def _assert_same_run(jtrace, tpool, treads, tcrash):
    jpool = jtrace.pool
    assert _tickets(tpool) == _tickets(jpool)
    assert tpool.linearization == jpool.linearization
    assert tpool.epoch_log == jpool.epoch_log
    assert _stats(tpool) == _stats(jpool)
    assert tpool.epoch_window() == jpool.epoch_window()
    assert tpool.ring.evicted == jpool.ring.evicted
    jreads = [(r.epoch, r.pairs, r.results, r.mode, r.starved)
              for r in jtrace.reads]
    assert treads == jreads
    jcrash = (None if jtrace.crash is None else
              (jtrace.crash.stage, jtrace.crash.epoch_attempted))
    assert tcrash == jcrash
    for what, t, j in (("head", tpool._head, jpool._head),
                       ("snapshot", tpool.snapshot(), jpool.snapshot())):
        for f, a, b in zip(T.GraphState._fields, state_to_numpy(t), j):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{what}: {f}")
    lo, hi = jpool.epoch_window()
    for e in (lo, (lo + hi) // 2):
        for f, a, b in zip(T.GraphState._fields,
                           state_to_numpy(tpool.state_at(e)),
                           jpool.state_at(e)):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"state_at({e}): {f}")


def _both(schedule, *, jfault=None, tfault=None, **kw):
    jtrace = run_schedule(schedule, fault=jfault, **kw)
    tpool, treads, tcrash = run_port(schedule, fault=tfault, **kw)
    _assert_same_run(jtrace, tpool, treads, tcrash)
    return jtrace, tpool


@pytest.mark.parametrize("seed,conflict,remv", [(0, 0.5, 0.1), (1, 1.0, 0.1),
                                                (2, 0.0, 0.0), (3, 0.7, 0.4)])
def test_random_schedules_match_jax(seed, conflict, remv):
    rng = random.Random(seed)
    programs = gen_client_programs(rng, clients=3, batches_per_client=3,
                                   conflict_rate=conflict, remv_rate=remv)
    schedule = random_schedule(rng, programs, epoch_read_rate=0.25,
                               tt_read_rate=0.3)
    _both(schedule, capacity=40, retain_epochs=6)


def test_every_interleaving_of_a_small_program_matches_jax():
    rng = random.Random(7)
    programs = gen_client_programs(rng, clients=2, batches_per_client=2,
                                   conflict_rate=0.8, max_lanes=3)
    schedules = list(enumerate_interleavings(programs, limit=6))
    assert len(schedules) == 6
    for schedule in schedules:
        _both(schedule, capacity=33)


def _fault_schedule(seed=11):
    rng = random.Random(seed)
    programs = gen_client_programs(rng, clients=3, batches_per_client=3,
                                   conflict_rate=0.3, remv_rate=0.0)
    return random_schedule(rng, programs, pump_rate=0.3, read_rate=0.2)


@pytest.mark.parametrize("plan,delays", [
    ([("c0", "admit")], {}),
    ([("c1", "apply")], {}),
    ([("c0", "apply"), ("c2", "admit")], {("c0", "apply"): 1}),
    ([("*", "wal-append")], {("*", "wal-append"): 2}),
    ([("*", "wal-fsync")], {("*", "wal-fsync"): 1}),
    ([("*", "post-publish-pre-ack")], {("*", "post-publish-pre-ack"): 3}),
], ids=["admit", "apply", "apply+admit", "wal-append", "wal-fsync",
        "post-publish"])
def test_fault_plans_match_jax(plan, delays):
    jf = JFault(plan=list(plan), delays=dict(delays))
    tf = TFault(plan=list(plan), delays=dict(delays))
    jtrace, tpool = _both(_fault_schedule(), jfault=jf, tfault=tf,
                          capacity=40)
    assert tf.fired == jf.fired and sorted(tf.fired) == sorted(plan)
    if plan[0][0] != "*":
        assert tpool.stats.aborted == len(plan)
    else:
        assert jtrace.crash is not None


def test_grow_and_replay_from_capacity_8_matches_jax():
    rng = random.Random(5)
    programs = gen_client_programs(rng, clients=3, batches_per_client=3,
                                   private_keys=6, conflict_rate=0.2,
                                   remv_rate=0.0, max_lanes=6)
    programs["c0"].insert(0, [(T.OP_ADD_V, k, -1, -1)
                              for k in range(300, 311)])
    schedule = random_schedule(rng, programs, tt_read_rate=0.3)
    jtrace, tpool = _both(schedule, capacity=8)
    assert tpool.stats.grow_events == jtrace.pool.stats.grow_events >= 1
    assert tpool.snapshot().capacity > 8


def test_exclusive_remove_vertex_batches_run_alone_as_in_jax():
    rng = random.Random(9)
    programs = gen_client_programs(rng, clients=3, batches_per_client=3,
                                   conflict_rate=0.0, remv_rate=0.5)
    schedule = random_schedule(rng, programs, pump_rate=0.2)
    jtrace, tpool = _both(schedule, capacity=40, max_inflight=4)
    excl = [t for t in tpool.tickets.values() if t.exclusive]
    assert excl
    for t in excl:
        same_epoch = [u for u in tpool.tickets.values()
                      if u.status == "applied" and u.epoch == t.epoch]
        assert same_epoch == [t]


def test_batch_footprint_and_buckets():
    assert batch_footprint([(T.OP_ADD_E, 3, 5), (T.OP_CON_V, 9)]) == (
        frozenset({3, 5, 9}), False)
    assert batch_footprint([(T.OP_REM_V, 2)]) == (frozenset({2}), True)
    assert batch_footprint([(T.OP_ADD_E, -1, 4)])[1] is True
    assert [_next_pow2(n) for n in (1, 8, 9, 64, 65)] == [8, 8, 16, 64, 128]


def test_four_threads_submit_at_once_and_replay_serially():
    pool = IngestPool(T.make_graph(64, device="cpu"), max_inflight=4)
    hot = [0, 1, 2, 31]

    def client(c):
        r = random.Random(100 + c)
        for _ in range(6):
            ops = []
            for _ in range(r.randint(1, 4)):
                keys = hot if r.random() < 0.5 else range(10 * c + 40,
                                                          10 * c + 44)
                opc = r.choice([T.OP_ADD_V, T.OP_ADD_V, T.OP_ADD_E,
                                T.OP_ADD_E, T.OP_REM_E, T.OP_CON_E])
                ops.append((opc, r.choice(list(keys)), r.choice(list(keys)),
                            -1))
            pool.submit(f"t{c}", ops)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    pool.flush()
    assert pool.stats.applied == 24 and pool.queue_depth() == 0
    oracle = T.GraphOracle()
    for bid in pool.linearization:
        t = pool.tickets[bid]
        assert oracle.apply_batch([_norm(op) for op in t.ops]) == \
            [int(x) for x in t.results], f"batch {bid}"
    by_client = {}
    for bid in pool.linearization:
        by_client.setdefault(pool.tickets[bid].client_id, []).append(bid)
    assert all(b == sorted(b) for b in by_client.values())
    head = pool.snapshot()
    vkey, valive, _, ecnt, _, _ = state_to_numpy(head)
    assert {int(vkey[s]): int(ecnt[s]) for s in np.flatnonzero(valive)} == \
        oracle.ecnt
    _, edges = to_networkx_like(head)
    assert set(edges) == oracle.edges
    assert bool(T.transpose_invariant(head))


@pytest.mark.parametrize("kw,err", [({"wal": object()}, NotImplementedError),
                                    ({"ckpt": object()}, NotImplementedError),
                                    ({"mesh": object()}, TypeError)],
                         ids=["wal", "ckpt", "mesh"])
def test_durability_and_mesh_wait_for_later_slices(kw, err):
    with pytest.raises(err, match="A9" if err is NotImplementedError
                       else "A10"):
        IngestPool(T.make_graph(8, device="cpu"), **kw)
