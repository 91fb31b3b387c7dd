"""Seating a state into the port's ingest pool (``IngestPool.seat``, the
``GraphCoServer.state`` setter under a pool; DESIGN.md §12, §13): the seat
publishes the next epoch and restarts the ring; the head equals the
serial engine's replay of the linearization since the last seat, on the
seated state; a busy, durable or sharded pool refuses and stays as it
was; a seated pool runs a client stream as the JAX pool built on the same
state does; and the seat, the publish and the ring's push are traced.
The JAX server refuses the assignment (tests/test_serving_stats.py)."""
import random

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro.runtime.ingest import IngestPool as JPool
from repro_torch.convert import state_to_numpy
from repro_torch.core.distributed import make_graph_mesh
from repro_torch.core.epochs import EpochEvictedError
from repro_torch.core.ops import apply_ops, compact
from repro_torch.obs import trace
from repro_torch.obs.trace import PORT_SPANS
from repro_torch.runtime.ingest import IngestPool, SeatRefused
from repro_torch.runtime.serve_loop import GraphCoServer
from repro_torch.runtime.wal import WriteAheadLog

FIELDS = T.GraphState._fields
KEYS = 24          # loaded keys 0 .. KEYS - 1, churn keys above them
CAP = 40
POOL = dict(max_inflight=4, max_coalesce_lanes=32, retain_epochs=6)


def _loaded(seed: int, capacity: int = CAP):
    """A seeded store with removed vertices compacted away: what the
    benchmark seats (a loaded graph, a compaction)."""
    rng = np.random.default_rng(seed)
    st = T.make_graph(capacity, device="cpu")
    st, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_V, k) for k in range(KEYS + 4)], device="cpu"))
    edges = rng.integers(0, KEYS, (3 * KEYS, 2))
    st, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_E, int(a), int(b)) for a, b in edges], device="cpu"))
    st, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_REM_V, KEYS + 1), (T.OP_REM_V, KEYS + 3)], device="cpu"))
    return compact(st)


def _rounds(seed: int, n: int = 6) -> list:
    """Client batches a round: three clients of 4 lanes over the loaded
    and churn keys, and every third round an exclusive RemoveVertex
    client."""
    r = random.Random(seed)
    out = []
    for i in range(n):
        batches = []
        for c in range(3):
            ops = []
            for _ in range(4):
                opc = r.choice([T.OP_ADD_V, T.OP_CON_V, T.OP_ADD_E,
                                T.OP_ADD_E, T.OP_REM_E, T.OP_CON_E])
                if opc in (T.OP_ADD_V, T.OP_CON_V):
                    ops.append((opc, r.randrange(KEYS, KEYS + 8)))
                else:
                    ops.append((opc, r.randrange(KEYS), r.randrange(KEYS)))
            batches.append((f"c{c}", ops))
        if i % 3 == 0:
            batches.append(("c3", [(T.OP_REM_V, r.randrange(KEYS, KEYS + 8)),
                                   (T.OP_ADD_V, r.randrange(KEYS, KEYS + 8))]))
        out.append(batches)
    return out


def _drive(pool, rounds) -> list:
    """Submit each round's batches in client order, then pump until the
    round's batches have landed; the tickets in submission order."""
    tickets = []
    for batches in rounds:
        tickets += [pool.submit(c, ops) for c, ops in batches]
        pool.flush()
    return tickets


def _fields(state) -> dict:
    return dict(zip(FIELDS, state_to_numpy(state)))


def _assert_same(got, want, what):
    for f, a in want.items():
        np.testing.assert_array_equal(got[f], a, err_msg=f"{what}: {f}")


def _replay(pool, seated):
    """The serial engine ``apply_ops`` over the linearization since the
    last seat, batch by batch, on the state seated then: (state, codes by
    batch id)."""
    st, codes = seated, {}
    for bid in pool.linearization[pool.last_seat[1]:]:
        st, res = apply_ops(st, T.make_op_batch(pool.tickets[bid].ops,
                                                device="cpu"))
        codes[bid] = res.numpy()
    return st, codes


def _picture(pool) -> dict:
    """What a refused seat must leave as it was."""
    return {"epoch": pool.epoch, "snapshot": pool.snapshot(),
            "head": pool._head, "ring": pool.ring,
            "window": pool.epoch_window(), "log": dict(pool.epoch_log),
            "lin": list(pool.linearization), "seat": pool.last_seat,
            "queue": pool.queue_depth(), "stats": pool.stats.snapshot()}


def test_seat_publishes_the_next_epoch_and_resets_the_ring():
    pool = IngestPool(T.make_graph(CAP, device="cpu"), **POOL)
    pool.submit("a", [(T.OP_ADD_V, k) for k in range(KEYS)])
    pool.flush()
    _drive(pool, _rounds(1, 2))
    before = pool.epoch
    assert before >= 3 and pool.state_at(1) is not None
    records, evicted = len(pool.ring), pool.ring.evicted
    old_ring, prefix = pool.ring, len(pool.linearization)
    seated = _loaded(2)
    assert pool.seat(seated) == before + 1
    assert pool.epoch == before + 1 and pool.snapshot() is seated
    assert pool.snapshot_epoch() == (before + 1, seated)
    assert pool.last_seat == (before + 1, prefix)
    assert pool.epoch_window() == (before + 1, before + 1)
    assert pool.epoch_log == {before + 1: prefix}
    assert pool.ring is not old_ring and len(pool.ring) == 0
    assert pool.ring.evicted == evicted + records
    assert pool.stats.epochs == before + 1
    assert pool.stats.epochs_retained == 1
    assert pool.stats.epochs_evicted == evicted + records
    for e in range(before + 1):
        with pytest.raises(EpochEvictedError):
            pool.state_at(e)
        with pytest.raises(EpochEvictedError):
            pool.linearization_prefix(e)
    assert pool.linearization_prefix(before + 1) == prefix
    # the old ring still answers a reader that took it before the seat
    assert old_ring.window()[1] == before
    # the seated epoch is rebuilt bit for bit once later rounds publish
    _drive(pool, _rounds(3, 1))
    assert pool.epoch_window() == (before + 1, pool.epoch)
    assert pool.epoch > before + 1
    _assert_same(_fields(pool.state_at(before + 1)), _fields(seated),
                 "state_at(seat)")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_head_is_the_replay_since_the_last_seat(seed):
    """Seat, a client stream, seat the compaction of the head, another
    stream: the head and every landed batch's codes equal ``apply_ops``
    replaying the linearization since the last seat on the state seated
    then, six arrays bit for bit."""
    pool = IngestPool(T.make_graph(8, device="cpu"), **POOL)
    pool.submit("a", [(T.OP_ADD_V, 1)])
    pool.flush()
    pool.seat(_loaded(seed))
    _drive(pool, _rounds(10 + seed))
    st, codes = _replay(pool, _loaded(seed))
    _assert_same(_fields(pool.snapshot()), _fields(st), "head, first seat")
    seated = compact(pool.snapshot())
    pool.seat(seated)
    assert pool.last_seat == (pool.epoch, len(pool.linearization))
    tickets = _drive(pool, _rounds(20 + seed))
    assert all(t.status == "applied" for t in tickets)
    assert pool.stats.retries > 0            # some batches met a conflict
    st, codes = _replay(pool, seated)
    assert sorted(codes) == sorted(t.batch_id for t in tickets)
    for t in tickets:
        np.testing.assert_array_equal(t.results, codes[t.batch_id],
                                      err_msg=f"batch {t.batch_id}")
    _assert_same(_fields(pool.snapshot()), _fields(st), "head, second seat")
    _assert_same(_fields(pool._head), _fields(st), "writer's head")
    assert bool(T.transpose_invariant(pool.snapshot()))


def _queued(pool, tmp_path):
    pool.submit("a", [(T.OP_ADD_V, 3)])
    return r"1 client batch\(es\) queued"


def _round(pool, tmp_path):
    pool._admission.acquire()          # a round stands in
    return "admission round is running"


@pytest.mark.parametrize("busy", [_queued, _round], ids=["queued", "round"])
def test_busy_pool_refuses_a_seat_and_stays_as_it_was(busy, tmp_path):
    pool = IngestPool(_loaded(4), **POOL)
    _drive(pool, _rounds(5, 2))
    reason = busy(pool, tmp_path)
    was = _picture(pool)
    with pytest.raises(SeatRefused, match=reason):
        pool.seat(_loaded(6))
    now = _picture(pool)
    for k in ("snapshot", "head", "ring"):
        assert now.pop(k) is was.pop(k), k
    assert now == was
    if pool._admission.locked():
        pool._admission.release()
    pool.flush()
    assert pool.queue_depth() == 0
    assert pool.seat(_loaded(6)) == pool.epoch


def test_durable_pool_refuses_a_seat_and_stays_as_it_was(tmp_path):
    wal = WriteAheadLog(tmp_path / "wal.log")
    pool = IngestPool(_loaded(7), wal=wal, **POOL)
    _drive(pool, _rounds(8, 2))
    was = _picture(pool)
    records = wal.stats.records
    with pytest.raises(SeatRefused, match="write-ahead log"):
        pool.seat(_loaded(9))
    now = _picture(pool)
    for k in ("snapshot", "head", "ring"):
        assert now.pop(k) is was.pop(k), k
    assert now == was and wal.stats.records == records
    wal.close()
    # the server's setter goes through the same refusal
    srv = GraphCoServer(capacity=CAP, ingest=True, device="cpu",
                        wal_dir=str(tmp_path / "srv"))
    epoch = srv.pool.epoch
    with pytest.raises(SeatRefused, match="write-ahead log"):
        srv.state = _loaded(9)
    assert srv.pool.epoch == epoch
    srv.pool.wal.close()


def test_sharded_pool_refuses_a_seat_and_stays_as_it_was():
    mesh = make_graph_mesh(["cpu"], shards=8)
    pool = IngestPool(T.shard_state(mesh, _loaded(10)), **POOL)
    _drive(pool, _rounds(11, 2))
    was = _picture(pool)
    with pytest.raises(SeatRefused, match="mesh"):
        pool.seat(T.shard_state(mesh, _loaded(12)))
    now = _picture(pool)
    for k in ("snapshot", "head", "ring"):
        assert now.pop(k) is was.pop(k), k
    assert now == was
    # nor does a dense pool take a sharded state
    dense = IngestPool(_loaded(10), **POOL)
    with pytest.raises(SeatRefused, match="mesh"):
        dense.seat(T.shard_state(mesh, _loaded(12)))
    assert dense.epoch == 0


def _jax_state(state):
    return J.GraphState(*(jnp.asarray(a) for a in state_to_numpy(state)))


@pytest.mark.parametrize("seed", [0, 1])
def test_seated_pool_runs_a_stream_as_the_jax_pool_on_that_state(seed):
    """The port's pool seated on a state, and JAX's pool built on it, fed
    the same client batches in the same order: the same tickets (status,
    codes, retries, epochs counted from the seat), linearization, epoch
    log and ring window from the seat on, and six arrays of the head."""
    seated = _loaded(30 + seed)
    tpool = IngestPool(T.make_graph(16, device="cpu"), **POOL)
    jpool = JPool(_jax_state(seated), **POOL)
    base = tpool.seat(seated)
    rounds = _rounds(40 + seed, 8)
    tt, jt = _drive(tpool, rounds), _drive(jpool, rounds)
    assert [t.batch_id for t in tt] == [t.batch_id for t in jt]
    for a, b in zip(tt, jt):
        assert (a.client_id, a.status, a.retries, a.epoch - base) == (
            b.client_id, b.status, b.retries, b.epoch), a.batch_id
        np.testing.assert_array_equal(np.asarray(a.results),
                                      np.asarray(b.results))
    assert tpool.linearization == jpool.linearization
    assert {e - base: p for e, p in tpool.epoch_log.items()} == \
        jpool.epoch_log
    lo, hi = tpool.epoch_window()
    assert (lo - base, hi - base) == jpool.epoch_window()
    # the words as uint32 bit patterns in both packages
    for f, a, b in zip(FIELDS, state_to_numpy(tpool.snapshot()),
                       jpool.snapshot()):
        b = np.asarray(b)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for e in range(lo, hi + 1):
        for f, a, b in zip(FIELDS, state_to_numpy(tpool.state_at(e)),
                           jpool.state_at(e - base)):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"state_at({e}): {f}")


def _spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


def _inside(inner, outer) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_seat_publish_and_push_are_traced():
    pool = IngestPool(_loaded(50), **POOL)
    was = trace.enabled()
    try:
        with trace.capture() as rec:
            epoch = pool.seat(_loaded(51))
            host = pool.ring._host_bytes
            pool.submit("a", [(T.OP_ADD_E, 1, 2), (T.OP_ADD_V, KEYS + 5)])
            pool.submit("b", [(T.OP_ADD_E, 3, 4)])
            assert pool.pump() == 2
        ev = rec.events()
    finally:
        (trace.enable if was else trace.disable)()
    assert {"ingest.seat", "ingest.publish", "ring.push"} <= PORT_SPANS
    (seat,) = _spans(ev, "ingest.seat")
    assert seat["args"] == {"epoch": epoch, "capacity": CAP}
    (rnd,) = _spans(ev, "ingest.round")
    (pub,) = _spans(ev, "ingest.publish")
    (push,) = _spans(ev, "ring.push")
    (fused,) = _spans(ev, "ingest.fused_apply")
    assert _inside(pub, rnd) and _inside(push, pub)
    assert not _inside(pub, fused) and not _inside(seat, rnd)
    assert pub["args"] == {"epoch": epoch + 1}
    rec_ = pool.ring._records[-1]
    k = len(rec_.rows)
    assert k > 0 and fused["args"]["batches"] == 2
    assert push["args"] == {"epoch": epoch + 1, "rows": k,
                            "bytes": pool.ring._host_bytes - host}
    # int32 words: the version vector, then for each changed row its
    # index, its four scalar patches and its packed words' patch
    assert push["args"]["bytes"] == 4 * (2 * CAP + k * (5 + rec_.adj_xor
                                                        .shape[1]))


def test_server_seats_through_state_and_the_bare_setter_is_unchanged():
    srv = GraphCoServer(capacity=8, ingest=True, device="cpu")
    seated = _loaded(60)
    srv.state = seated
    assert srv.state is seated and srv.pool.epoch == 1
    tickets = [srv.submit_client(c, ops) for c, ops in _rounds(61, 1)[0]]
    srv.flush()
    assert all(t.status == "applied" and t.epoch >= 2 for t in tickets)
    head = srv.state
    srv.state = compact(head)                 # a compaction is a seat too
    assert srv.pool.last_seat == (srv.pool.epoch, len(srv.pool.linearization))
    answers, _ = srv.get_paths([(0, 1), (2, 3)])
    assert len(answers) == 2
    bare = GraphCoServer(capacity=8, device="cpu")
    bare.state = seated
    assert bare.state is seated and bare.pool is None
    codes = bare.submit([(T.OP_ADD_V, KEYS + 6)])
    assert list(codes) == [T.R_TRUE]
    # the store handed out above went to a copy; the state read stays
    assert bare.state is not seated
    assert not bool(seated.valive[seated.vkey == KEYS + 6].any())
