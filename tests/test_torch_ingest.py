"""The port's ingest pool (repro_torch.runtime.ingest) against the JAX
package's (repro.runtime.ingest), each driven by its own package's
schedule harness (``repro.testing.schedules`` and its port
``repro_torch.testing.schedules``) on the same schedules: seeded random
interleavings with head reads, hostile epoch-resolved reads and
time-travel reads, every interleaving of a small program, ``FaultInjector``
plans at ``admit`` and ``apply`` and the ``wal-append`` / ``wal-fsync`` /
``post-publish-pre-ack`` crash stages without a WAL, grow-and-replay from
capacity 8, and exclusive RemoveVertex batches. Compared: every ticket
(status, results, epoch, retries), the linearization, ``epoch_log``, the
reads, the stats apart from the ``wait*_s`` wall times, the ring window,
the crash and the final six arrays. Also: 4 threads submitting at once,
checked by serial replay through the port's oracle; and ``mesh=`` raises."""
import random
import threading

import numpy as np
import pytest

import repro_torch.core as T
from repro.runtime.fault import FaultInjector as JFault
from repro.testing.schedules import (enumerate_interleavings,
                                     gen_client_programs, random_schedule)
from repro.testing.schedules import run_schedule as jrun
from repro_torch.convert import state_to_numpy
from repro_torch.core.graph import to_networkx_like
from repro_torch.runtime.fault import FaultInjector as TFault
from repro_torch.runtime.ingest import (IngestPool, _next_pow2,
                                        batch_footprint)
from repro_torch.testing import schedules as tsched
from repro_torch.testing.schedules import _norm, check_aborted_invisible
from repro_torch.testing.schedules import run_schedule as trun

WALL = ("wait_s", "wait_max_s")


def _tickets(pool):
    return {bid: (t.client_id, t.status, None if t.results is None
                  else [int(x) for x in t.results], t.epoch, t.retries,
                  t.exclusive, sorted(t.footprint))
            for bid, t in pool.tickets.items()}


def _stats(pool):
    return {k: v for k, v in pool.stats.snapshot().items() if k not in WALL}


def _reads(trace):
    return [(r.epoch, r.pairs, r.results, r.mode, r.starved)
            for r in trace.reads]


def _crash(trace):
    return None if trace.crash is None else (trace.crash.stage,
                                             trace.crash.epoch_attempted)


def _assert_same_run(jtrace, ttrace):
    jpool, tpool = jtrace.pool, ttrace.pool
    assert _tickets(tpool) == _tickets(jpool)
    assert tpool.linearization == jpool.linearization
    assert tpool.epoch_log == jpool.epoch_log
    assert _stats(tpool) == _stats(jpool)
    assert tpool.epoch_window() == jpool.epoch_window()
    assert tpool.ring.evicted == jpool.ring.evicted
    assert _reads(ttrace) == _reads(jtrace)
    assert _crash(ttrace) == _crash(jtrace)
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
    jtrace = jrun(schedule, fault=jfault, **kw)
    ttrace = trun(schedule, fault=tfault, device="cpu", **kw)
    _assert_same_run(jtrace, ttrace)
    return jtrace, ttrace


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
    jtrace, ttrace = _both(_fault_schedule(), jfault=jf, tfault=tf,
                           capacity=40)
    assert tf.fired == jf.fired and sorted(tf.fired) == sorted(plan)
    if plan[0][0] != "*":
        assert ttrace.pool.stats.aborted == len(plan)
        check_aborted_invisible(ttrace)
    else:
        assert ttrace.crash is not None


def test_grow_and_replay_from_capacity_8_matches_jax():
    rng = random.Random(5)
    programs = gen_client_programs(rng, clients=3, batches_per_client=3,
                                   private_keys=6, conflict_rate=0.2,
                                   remv_rate=0.0, max_lanes=6)
    programs["c0"].insert(0, [(T.OP_ADD_V, k, -1, -1)
                              for k in range(300, 311)])
    schedule = random_schedule(rng, programs, tt_read_rate=0.3)
    jtrace, ttrace = _both(schedule, capacity=8)
    tpool = ttrace.pool
    assert tpool.stats.grow_events == jtrace.pool.stats.grow_events >= 1
    assert tpool.snapshot().capacity > 8


def test_exclusive_remove_vertex_batches_run_alone_as_in_jax():
    rng = random.Random(9)
    programs = gen_client_programs(rng, clients=3, batches_per_client=3,
                                   conflict_rate=0.0, remv_rate=0.5)
    schedule = random_schedule(rng, programs, pump_rate=0.2)
    _, ttrace = _both(schedule, capacity=40, max_inflight=4)
    tpool = ttrace.pool
    excl = [t for t in tpool.tickets.values() if t.exclusive]
    assert excl
    for t in excl:
        same_epoch = [u for u in tpool.tickets.values()
                      if u.status == "applied" and u.epoch == t.epoch]
        assert same_epoch == [t]


@pytest.mark.parametrize("seed", [0, 3])
def test_the_port_harness_draws_the_jax_schedules(seed):
    import repro.testing.schedules as jsched

    got = []
    for M in (jsched, tsched):
        rng = random.Random(seed)
        progs = M.gen_client_programs(rng, clients=3, batches_per_client=3,
                                      conflict_rate=0.6, remv_rate=0.2)
        sched = M.random_schedule(rng, progs, epoch_read_rate=0.3,
                                  tt_read_rate=0.3)
        small = {c: b[:2] for c, b in progs.items() if c != "c2"}
        got.append((progs, sched.steps,
                    [x.steps for x in M.enumerate_interleavings(small,
                                                                limit=5)]))
    assert got[1] == got[0]


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


@pytest.mark.parametrize("kw", [{"mesh": object()}], ids=["mesh"])
def test_durability_and_mesh_wait_for_later_slices(kw):
    with pytest.raises(TypeError, match="A10"):
        IngestPool(T.make_graph(8, device="cpu"), **kw)
