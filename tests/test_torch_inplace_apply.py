"""The fast engine's in-place entry (``core.ops.apply_ops_fast_``) and the
bare ``GraphCoServer`` that applies its batches through it.

``apply_ops_fast_`` equals ``apply_ops_fast`` bit for bit (codes and the
six state arrays) on random op streams with negative keys and batches that
overflow the free slots; it writes into its input exactly when the batch
names no negative key and cannot answer R_TABLE_FULL, and otherwise leaves
the input untouched. A bare server keeps its store's storage across
submits and answers as a lane-by-lane ``apply_ops`` replay; a state read
through ``state`` stays as it was, the next batch going to a copy; an
overflowing submit grows the untouched pre-batch state; an ingesting
server's retained epochs stay as they were published. On the card
(``cuda``-marked, skipped without one) the same holds with the serial pass
kernel, and a submit allocates less than one mirror. The tests read a
server's store as ``_state`` where reading ``state`` would hand it out.
This file does not import jax, so it runs on the card's installation:

    python -m pytest -q tests/test_torch_inplace_apply.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.convert import op_batch_from_numpy, state_to_numpy
from repro_torch.core.ops import apply_ops_fast_
from repro_torch.core.snapshot import get_paths_session
from repro_torch.kernels.serial_pass import ops as sp_ops
from repro_torch.runtime.serve_loop import GraphCoServer


def _host(state):
    return [a.copy() for a in state_to_numpy(state)]


def _same(state, want, what):
    for name, a, b in zip(T.GraphState._fields, state_to_numpy(state), want):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


def _cols(rng, b, nkeys, low):
    """One batch's columns: every opcode, AddV-heavy, keys from ``low``."""
    opc = rng.choice(7, b, p=[0.05, 0.35, 0.1, 0.1, 0.2, 0.1, 0.1])
    k1 = rng.integers(low, nkeys, b)
    k2 = rng.integers(low, nkeys, b)
    expect = np.where(rng.random(b) < 0.2, rng.integers(0, 4, b), -1)
    return [np.asarray(c, np.int32) for c in (opc, k1, k2, expect)]


def _names_negative(cols) -> bool:
    opc, k1, k2 = cols[:3]
    vert = np.isin(opc, (T.OP_ADD_V, T.OP_REM_V, T.OP_CON_V))
    edge = np.isin(opc, (T.OP_ADD_E, T.OP_REM_E, T.OP_CON_E))
    return bool((vert & (k1 < 0)).any() or (edge & ((k1 < 0) | (k2 < 0))).any())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_in_place_entry_equals_the_functional_one(seed):
    rng = np.random.default_rng([35, seed])
    state = T.make_graph(40, device="cpu")
    seen = set()
    for step in range(24):
        if step % 6 == 5:
            state = T.compact(state)
        cols = _cols(rng, 16, 64, -2 if rng.random() < 0.5 else 0)
        ops = op_batch_from_numpy(*cols, device="cpu")
        before = _host(state)
        f_st, f_res = T.apply_ops_fast(state, ops)
        _same(state, before, f"functional input @{step}")
        got, res = apply_ops_fast_(state, ops)
        np.testing.assert_array_equal(res.numpy(), f_res.numpy(),
                                      err_msg=f"codes @{step}")
        _same(got, state_to_numpy(f_st), f"state @{step}")
        full = bool((f_res == T.R_TABLE_FULL).any())
        negative = _names_negative(cols)
        in_place = got is state
        # only a batch that could answer R_TABLE_FULL, or names a negative
        # key, is applied to a copy
        assert in_place == (not full and not negative), step
        if in_place:
            assert not bool((res == T.R_TABLE_FULL).any())
        else:
            _same(state, before, f"untouched input @{step}")
        seen.add((in_place, full))
        state = got
    # both entries' cases came: in place, and copies with and without a
    # full table
    assert {(True, False), (False, True), (False, False)} <= seen


def _server_batches(rng, n, nkeys, lanes):
    return [[tuple(int(x) for x in op) for op in zip(*_cols(rng, lanes,
                                                            nkeys, 0))]
            for _ in range(n)]


def _replay(state, ops):
    return T.apply_ops(state, T.make_op_batch(ops, device="cpu"))


def _paths(state, pairs):
    return get_paths_session(lambda: state, pairs, max_rounds=64)[0]


def test_bare_server_keeps_its_store_and_answers_as_the_replay():
    rng = np.random.default_rng(351)
    srv = GraphCoServer(capacity=96, device="cpu")
    ref = T.make_graph(96, device="cpu")
    load = [(T.OP_ADD_V, k) for k in range(40)]
    load += [(T.OP_ADD_E, int(a), int(b))
             for a, b in rng.integers(0, 40, (80, 2))]
    batches = [load] + _server_batches(rng, 8, 48, 24)
    store = srv._state
    ptrs = [t.data_ptr() for t in store]
    for i, ops in enumerate(batches):
        codes = srv.submit(ops)
        ref, want = _replay(ref, ops)
        np.testing.assert_array_equal(codes, want.numpy(),
                                      err_msg=f"codes @{i}")
        assert srv._state is store
        assert [t.data_ptr() for t in srv._state] == ptrs
        _same(srv._state, state_to_numpy(ref), f"state @{i}")
        pairs = [tuple(int(x) for x in p)
                 for p in rng.integers(0, 48, (6, 2))]
        answers, _ = srv.get_paths(pairs)
        assert answers == _paths(ref, pairs), i
    assert srv.grow_events == 0


def test_a_state_read_stays_as_it_was():
    rng = np.random.default_rng(354)
    srv = GraphCoServer(capacity=96, device="cpu")
    ref = T.make_graph(96, device="cpu")
    a, b, c = _server_batches(rng, 3, 48, 24)
    for ops in (a, b, c):
        srv.submit(ops)
        read = srv.state
        held = _host(read)
        ref, _ = _replay(ref, ops)
        # the batch after a read goes to a copy, which the server owns
        srv.submit([(T.OP_ADD_V, 47), (T.OP_REM_V, 47)])
        ref, _ = _replay(ref, [(T.OP_ADD_V, 47), (T.OP_REM_V, 47)])
        _same(read, held, "the state read")
        assert srv._state is not read
        store = srv._state
        srv.submit([(T.OP_CON_V, 1)])
        assert srv._state is store
        _same(store, state_to_numpy(ref), "the store")
    # a state assigned to ``state`` is the server's store
    assigned = T.make_graph(96, device="cpu")
    srv.state = assigned
    srv.submit([(T.OP_ADD_V, 3)])
    assert srv._state is assigned and bool(assigned.valive.any())


def test_overflowing_submit_grows_the_untouched_pre_batch_state():
    srv = GraphCoServer(capacity=16, device="cpu")
    srv.submit([(T.OP_ADD_V, k) for k in range(12)])
    srv.submit([(T.OP_ADD_E, k, (3 * k + 1) % 12) for k in range(12)])
    pre = srv._state
    before = _host(pre)
    # 6 AddV for 4 free slots, an edge write and lookups around them
    batch = ([(T.OP_ADD_E, 1, 5), (T.OP_REM_V, 3)]
             + [(T.OP_ADD_V, 100 + i) for i in range(6)]
             + [(T.OP_ADD_E, 100, 1), (T.OP_CON_V, 105)])
    codes = srv.submit(batch)
    assert srv.grow_events == 1 and srv._state.capacity == 32
    _same(pre, before, "the pre-batch store")
    want_st, want = _replay(T.grow(pre, 32), batch)
    np.testing.assert_array_equal(codes, want.numpy())
    _same(srv._state, state_to_numpy(want_st), "grown state")
    assert T.R_TABLE_FULL not in codes.tolist()
    # the grown store is the server's own: the next batch lands in it
    store = srv._state
    srv.submit([(T.OP_ADD_E, 105, 100)])
    assert srv._state is store


def test_ingesting_server_keeps_its_retained_epochs():
    rng = np.random.default_rng(352)
    srv = GraphCoServer(capacity=96, device="cpu", ingest=True)
    srv.submit([(T.OP_ADD_V, k) for k in range(40)])
    kept = {}
    for ops in _server_batches(rng, 4, 48, 16):
        srv.submit(ops)
        epoch, st = srv.pool.snapshot_epoch()
        kept[epoch] = (st, _host(st))
    for ops in _server_batches(rng, 4, 48, 16):
        srv.submit(ops)
    for epoch, (st, host) in kept.items():
        _same(st, host, f"published state of epoch {epoch}")
        _same(srv.pool.state_at(epoch), host, f"ring's epoch {epoch}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the serial pass kernel needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bare_server_applies_in_place_within_a_mirror(cuda_device):
    rng = np.random.default_rng(353)
    cap, nkeys = 8192, 6000
    srv = GraphCoServer(capacity=cap, device=cuda_device)
    ref = T.make_graph(cap, device="cpu")
    load = [(T.OP_ADD_V, k) for k in range(5000)]
    load += [(T.OP_ADD_E, int(a), int(b))
             for a, b in rng.integers(0, 5000, (20000, 2))]
    for i in range(0, len(load), 1000):    # the schedule is [B, B]
        srv.submit(load[i:i + 1000])
    ref, _ = _replay(ref, load)
    store = srv._state
    ptrs = [t.data_ptr() for t in store]
    mirror = store.adj_packed.numel() * store.adj_packed.element_size()
    launches = sp_ops.launches
    for i, ops in enumerate(_server_batches(rng, 6, nkeys, 128)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        codes = srv.submit(ops)
        rise = torch.cuda.max_memory_allocated() - held
        assert rise < mirror, (i, rise, mirror)
        ref, want = _replay(ref, ops)
        np.testing.assert_array_equal(codes, want.numpy(),
                                      err_msg=f"codes @{i}")
        assert srv._state is store
        assert [t.data_ptr() for t in srv._state] == ptrs
        _same(srv._state, state_to_numpy(ref), f"state @{i}")
        pairs = [tuple(int(x) for x in p)
                 for p in rng.integers(0, nkeys, (8, 2))]
        assert srv.get_paths(pairs)[0] == _paths(ref, pairs), i
    assert sp_ops.launches > launches      # the kernel took the serial lanes
