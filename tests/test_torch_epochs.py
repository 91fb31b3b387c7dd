"""The port's epoch ring (repro_torch.core.epochs) against the JAX
package's (repro.core.epochs), fed the same published states: the window
and eviction count, every record field (patch words as uint32),
``state_at`` of every retained epoch in all six arrays, ``versions_at``,
``epoch_of_versions`` (a hit and None), ``diff`` for every pair, the typed
eviction error, the grow-barrier reset, the non-consecutive
``ValueError``, ``retain=1``, ``dump`` leaves in dtype and bytes and
``load`` of a JAX dump. Also: ``state_at`` and ``diff`` build no [V, V]
transient, and ``push`` copies only the changed rows off the device.
Capacity 40 (not a multiple of 32) with keys in slots 31 and 39."""
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
import repro_torch.core.epochs as TE
import repro_torch.core.graph as TG
from repro.runtime.ingest import IngestPool as JPool
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.runtime.ingest import IngestPool as TPool

FIELDS = ("vkey", "valive", "vver", "ecnt", "adj_packed", "adj_in_packed")
CAP = 40


def _np_state(st):
    """Six numpy arrays of a state of either package, words as uint32."""
    if isinstance(st, T.GraphState):
        return state_to_numpy(st)
    return tuple(np.asarray(x) for x in st)


def _assert_same_state(got, want, what):
    for f, a, b in zip(FIELDS, _np_state(got), _np_state(want)):
        assert a.dtype == b.dtype, f"{what}: {f} dtype {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")


def _stream(seed=0, n=14):
    """A list of JAX states published in order: vertex adds filling slots
    31 and 39, edge churn into and out of them, RemoveVertex of a hub, and
    one no-op round (a record with no rows)."""
    rng = np.random.default_rng(seed)
    st = J.make_graph(CAP)
    states = [st]
    st, _ = J.apply_ops_fast(st, J.make_op_batch(
        [(J.OP_ADD_V, k) for k in range(CAP)]))
    states.append(st)
    for i in range(n):
        if i == 4:
            ops = [(J.OP_CON_V, 3)]                      # changes nothing
        elif i == 7:
            ops = [(J.OP_REM_V, 31)]                     # a hub goes
        else:
            ks = rng.integers(0, CAP, 12)
            ls = rng.integers(0, CAP, 12)
            ops = [(J.OP_ADD_E if rng.random() < 0.7 else J.OP_REM_E,
                    int(k), int(l)) for k, l in zip(ks, ls)]
            ops += [(J.OP_ADD_E, 31, 39), (J.OP_ADD_E, 39, 31),
                    (J.OP_ADD_E, int(ks[0]), 31)]
            if i == 9:
                ops.append((J.OP_ADD_V, 31))
        st, _ = J.apply_ops_fast(st, J.make_op_batch(ops))
        states.append(st)
    return states


def _rings(states, retain):
    jr, tr = J.EpochRing(retain), T.EpochRing(retain)
    tstates = [state_from_numpy(*_np_state(s), device="cpu") for s in states]
    jr.reset(0, states[0])
    tr.reset(0, tstates[0])
    for e, (js, ts) in enumerate(zip(states[1:], tstates[1:]), 1):
        jr.push(e, js)
        tr.push(e, ts)
    return jr, tr, tstates


def _record_fields(rec):
    out = {}
    for f in ("epoch", "capacity", "versions", "rows", "vkey_xor",
              "valive_xor", "vver_xor", "ecnt_xor", "adj_xor"):
        out[f] = getattr(rec, f)
    return out


def _assert_same_records(tr, jr):
    assert len(tr._records) == len(jr._records)
    for a, b in zip(tr._records, jr._records):
        fa, fb = _record_fields(a), _record_fields(b)
        for f in fa:
            x, y = np.asarray(fa[f]), np.asarray(fb[f])
            assert x.dtype == y.dtype and x.shape == y.shape, (a.epoch, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{a.epoch}: {f}")


@pytest.mark.parametrize("retain", [1, 4, 64])
def test_ring_matches_jax_on_a_published_stream(retain):
    states = _stream()
    jr, tr, _ = _rings(states, retain)
    assert tr.window() == jr.window()
    assert len(tr) == len(jr) and tr.evicted == jr.evicted
    _assert_same_records(tr, jr)
    lo, hi = jr.window()
    assert [tr.contains(e) for e in range(hi + 2)] == \
        [jr.contains(e) for e in range(hi + 2)]
    for e in range(lo, hi + 1):
        got = tr.state_at(e)
        _assert_same_state(got, jr.state_at(e), f"state_at({e})")
        _assert_same_state(got, states[e], f"published {e}")
        np.testing.assert_array_equal(tr.versions_at(e), jr.versions_at(e))
        for e2 in range(lo, hi + 1):
            a, b = tr.diff(e, e2), jr.diff(e, e2)
            assert (a.e_from, a.e_to) == (b.e_from, b.e_to)
            for f in ("rows", "keys_before", "keys_after"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f"diff {f}")


def test_epoch_of_versions_matches_jax_hit_and_miss():
    states = _stream()
    jr, tr, _ = _rings(states, 6)
    lo, hi = jr.window()
    for e in range(lo - 2, hi + 1):
        vv = np.asarray(J.version_vector(states[e]))
        got = tr.epoch_of_versions(vv, CAP)
        assert got == jr.epoch_of_versions(vv, CAP)
        assert (got is not None) == (e >= lo)
        # the port also takes the index's device tensor
        assert tr.epoch_of_versions(T.version_vector(
            state_from_numpy(*_np_state(states[e]), device="cpu")),
            CAP) == got
    vv = np.asarray(J.version_vector(states[-1])).copy()
    vv[0, 0] += 1000
    assert tr.epoch_of_versions(vv, CAP) is None
    assert jr.epoch_of_versions(vv, CAP) is None
    assert tr.epoch_of_versions(vv, CAP + 8) is None


@pytest.mark.parametrize("call", ["state_at", "versions_at", "diff_lo",
                                  "diff_hi"])
def test_evicted_error_carries_epoch_and_window_as_jax(call):
    states = _stream()
    jr, tr, _ = _rings(states, 5)
    lo, hi = jr.window()
    errs = []
    for ring in (jr, tr):
        fn = {"state_at": lambda: ring.state_at(lo - 1),
              "versions_at": lambda: ring.versions_at(hi + 1),
              "diff_lo": lambda: ring.diff(lo - 2, hi),
              "diff_hi": lambda: ring.diff(lo, hi + 3)}[call]
        with pytest.raises(LookupError) as ei:
            fn()
        errs.append((type(ei.value).__name__, ei.value.epoch,
                     ei.value.window, str(ei.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] == "EpochEvictedError"


def test_grow_barrier_resets_and_non_consecutive_push_raises():
    states = _stream(n=4)
    jr, tr, tstates = _rings(states, 8)
    jg = J.grow(states[-1], 2 * CAP)
    tg = T.grow(tstates[-1], 2 * CAP)
    n = len(states)
    jr.push(n, jg)
    tr.push(n, tg)
    assert tr.window() == jr.window() == (n, n)
    assert tr.evicted == jr.evicted == n - 1
    _assert_same_state(tr.state_at(n), jr.state_at(n), "after the grow")
    with pytest.raises(J.EpochEvictedError):
        jr.state_at(n - 1)
    with pytest.raises(T.EpochEvictedError):
        tr.state_at(n - 1)
    assert tr.epoch_of_versions(np.asarray(J.version_vector(states[-1])),
                                CAP) is None
    for ring, st in ((jr, jg), (tr, tg)):
        with pytest.raises(ValueError, match="non-consecutive"):
            ring.push(n + 2, st)
    with pytest.raises(ValueError):
        T.EpochRing(0)


def test_dump_leaves_match_jax_bytes_and_load_reads_a_jax_dump():
    states = _stream()
    jr, tr, _ = _rings(states, 5)
    jl, jm = jr.dump()
    tl, tm = tr.dump()
    assert tm == jm
    assert len(tl) == len(jl) == 5 + 7 * jm["n_records"]
    for i, (a, b) in enumerate(zip(tl, jl)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert a.tobytes() == b.tobytes(), i
    loaded = T.EpochRing.load(jl, jm, device="cpu")
    assert loaded.window() == jr.window() and loaded.evicted == jr.evicted
    _assert_same_records(loaded, jr)
    lo, hi = jr.window()
    for e in range(lo, hi + 1):
        _assert_same_state(loaded.state_at(e), jr.state_at(e), f"loaded {e}")
    again = J.EpochRing.load(tl, tm)
    _assert_same_records(tr, again)
    empty = T.EpochRing.load(*J.EpochRing(3).dump(), device="cpu")
    assert empty._latest is None and empty.window() == (0, 0)


def test_state_at_and_diff_build_no_dense_transient(monkeypatch):
    states = _stream()
    jr, tr, _ = _rings(states, 64)

    def boom(*a, **k):
        raise AssertionError("a [V, V] transient on the ring's read path")

    for name in ("pack_transpose", "pack_bits", "unpack_bits",
                 "unpack_dense"):
        monkeypatch.setattr(TG, name, boom)
        if hasattr(TE, name):
            monkeypatch.setattr(TE, name, boom)
    lo, hi = jr.window()
    for e in range(lo, hi):
        _assert_same_state(tr.state_at(e), jr.state_at(e), f"state_at({e})")
        a, b = tr.diff(e, hi), jr.diff(e, hi)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.keys_before, b.keys_before)


def test_push_copies_only_the_changed_rows_off_the_device():
    v = 64
    w = TG.packed_width(v)
    st = T.make_graph(v, device="cpu")
    st, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_V, k) for k in range(v)], device="cpu"))
    ring = T.EpochRing(8)
    ring.reset(0, st)
    assert ring._host_bytes == 0          # reset keeps the state by reference
    assert ring._latest is st
    nxt, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_E, 3, 31), (T.OP_ADD_E, 63, 0)], device="cpu"))
    ring.push(1, nxt)
    rec = ring._records[-1]
    np.testing.assert_array_equal(rec.rows, [3, 63])
    k = 2
    # one copy: the version vector, the rows and five patches of k rows
    assert ring._host_bytes == 4 * (2 * v + 5 * k + k * w)
    full = sum(t.numel() * t.element_size() for t in nxt)
    assert ring._host_bytes * 2 < full
    assert ring._latest is nxt
    ring.push(2, nxt)                     # nothing changed: no rows
    assert ring._records[-1].rows.size == 0
    assert ring._host_bytes == 4 * (2 * v + 5 * k + k * w) + 4 * 2 * v


@pytest.mark.parametrize("field", FIELDS)
def test_a_published_state_written_in_place_raises(field):
    v = 40
    st = T.make_graph(v, device="cpu")
    st, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_V, k) for k in range(v)], device="cpu"))
    ring = T.EpochRing(8)
    ring.reset(0, st)
    nxt, _ = T.apply_ops_fast(st, T.make_op_batch(
        [(T.OP_ADD_E, 3, 31), (T.OP_ADD_E, 39, 0)], device="cpu"))
    ring.push(1, nxt)
    ring.state_at(0)
    t = getattr(nxt, field)
    t[31] ^= torch.ones_like(t[31])    # one in-place write
    for read in (lambda: ring.state_at(0), lambda: ring.diff(0, 1),
                 ring.dump, lambda: ring.push(2, nxt)):
        with pytest.raises(RuntimeError, match="written in place"):
            read()
    assert ring.window() == (0, 1)


def test_pools_retain_the_same_window_and_states():
    pools = []
    for M, Pool, dev in ((J, JPool, {}), (T, TPool, {"device": "cpu"})):
        pool = Pool(M.make_graph(CAP, **dev), retain_epochs=4)
        published = {0: pool.snapshot()}
        for r in range(5):
            pool.submit("c", [(M.OP_ADD_V, 7 * r % CAP),
                              (M.OP_ADD_V, 31), (M.OP_ADD_E, 31, 7 * r % CAP)])
            pool.flush()
            published[pool.epoch] = pool.snapshot()
        assert pool.state_at(pool.epoch) is pool.snapshot()
        pools.append((pool, published))
    (jp, jpub), (tp, tpub) = pools
    assert tp.epoch_window() == jp.epoch_window() == (2, 5)
    assert tp.epoch_log == jp.epoch_log
    for e in range(2, 6):
        _assert_same_state(tp.state_at(e), jp.state_at(e), f"pool {e}")
        _assert_same_state(tp.state_at(e), tpub[e], f"published {e}")
        assert tp.linearization_prefix(e) == jp.linearization_prefix(e)
    with pytest.raises(T.EpochEvictedError):
        tp.linearization_prefix(1)
