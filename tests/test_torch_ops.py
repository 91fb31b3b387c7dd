"""The port's batched mutation engines (repro_torch.core.ops) against the JAX
package's ``apply_ops_fast``: result codes and all six state arrays (slot
placement included), bit for bit, over op streams that cover all seven
opcodes, CAS ``expect``, negative and duplicate keys, a batch that
overflows to R_TABLE_FULL, ``grow`` and ``compact``; the transpose
invariant holds after every batch."""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro_torch.convert import op_batch_from_numpy, state_to_numpy
from repro_torch.core.graph import to_networkx_like


def _same(tstate, jstate, what):
    for name, a, b in zip(J.GraphState._fields, state_to_numpy(tstate),
                          jstate):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{what}: {name}")


def _batch(rng, b, nkeys):
    opc = rng.integers(0, 7, b)
    k1 = rng.integers(-2, nkeys, b)
    k2 = rng.integers(-2, nkeys, b)
    expect = np.where(rng.random(b) < 0.2, rng.integers(0, 4, b), -1)
    return [np.asarray(c, np.int32) for c in (opc, k1, k2, expect)]


def _both(cols):
    return (J.OpBatch(*(jnp.asarray(c) for c in cols)),
            op_batch_from_numpy(*cols, device="cpu"))


def _seeded(cap, nv, ne, rng):
    ops = [(J.OP_ADD_V, k) for k in range(nv)]
    ops += [(J.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, nv, (ne, 2))]
    ops += [(J.OP_ADD_E, k, 31) for k in range(0, nv, 5)]   # column 31
    cols = [np.zeros(len(ops), np.int32), np.zeros(len(ops), np.int32),
            np.full(len(ops), -1, np.int32), np.full(len(ops), -1, np.int32)]
    for i, op in enumerate(ops):
        for j, x in enumerate(op):
            cols[j][i] = x
    jb, tb = _both(cols)
    g, jr = J.apply_ops_fast(J.make_graph(cap), jb)
    t, tr = T.apply_ops_fast(T.make_graph(cap, device="cpu"), tb)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    _same(t, g, "seed")
    return g, t


@pytest.mark.parametrize("seed", [0, 1])
def test_op_streams_match_jax_fast_and_serial(seed):
    rng = np.random.default_rng(seed)
    g, t = _seeded(48, 40, 120, rng)
    saw_full = saw_cas = False
    for step in range(10):
        if step == 6:
            g, t = J.grow(g, 80), T.grow(t, 80)
        if step == 8:
            g, t = J.compact(g), T.compact(t)
            _same(t, g, "compact")
        cols = _batch(rng, 32, 60)
        jb, tb = _both(cols)
        g2, jr = J.apply_ops_fast(g, jb)
        t_fast, tr_fast = T.apply_ops_fast(t, tb)
        t_ser, tr_ser = T.apply_ops(t, tb)
        for what, tt, tr in (("fast", t_fast, tr_fast),
                             ("serial", t_ser, tr_ser)):
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr),
                                          err_msg=f"{what} codes @{step}")
            _same(tt, g2, f"{what} @{step}")
        assert bool(T.transpose_invariant(t_fast))
        saw_full |= bool((tr_fast == T.R_TABLE_FULL).any())
        saw_cas |= bool((tr_fast == T.R_CAS_FAIL).any())
        # the engines are functional: the input state is untouched
        _same(t, g, f"input @{step}")
        g, t = g2, t_fast
    assert saw_full and saw_cas


def test_single_ops_undirected_and_queries_match_jax():
    rng = np.random.default_rng(5)
    g, t = _seeded(70, 64, 200, rng)
    steps = [
        ("add_vertex", (100,)), ("add_vertex", (3,)),
        ("add_edge", (100, 31)), ("add_edge", (100, 31)),
        ("remove_edge", (100, 31)), ("remove_edge", (100, 7)),
        ("add_edge_undirected", (5, 63)), ("remove_edge_undirected", (5, 63)),
        ("add_edge_undirected", (9, 9)), ("remove_vertex", (31,)),
        ("remove_vertex", (31,)), ("add_edge", (31, 2)),
    ]
    for name, args in steps:
        g, jr = getattr(J, name)(g, *args)
        t, tr = getattr(T, name)(t, *args)
        assert int(tr) == int(jr), name
        _same(t, g, name)
        assert bool(T.transpose_invariant(t)), name
    for k in (0, 5, 31, 100, 1000):
        jn, jk = J.neighbors(g, k)
        tn, tk = T.neighbors(t, k)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert tuple(int(x) for x in T.degree(t, k)) == tuple(
            int(x) for x in J.degree(g, k))
    _same(T.compact(t), J.compact(g), "compact")


def test_fast_engine_input_with_no_lanes_and_full_overflow():
    g = J.make_graph(8)
    t = T.make_graph(8, device="cpu")
    cols = [np.full(12, J.OP_ADD_V, np.int32), np.arange(12, dtype=np.int32),
            np.full(12, -1, np.int32), np.full(12, -1, np.int32)]
    jb, tb = _both(cols)
    g, jr = J.apply_ops_fast(g, jb)
    t, tr = T.apply_ops_fast(t, tb)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert (tr.numpy()[8:] == T.R_TABLE_FULL).all()
    _same(t, g, "overflow")
    empty = op_batch_from_numpy(*(np.zeros(0, np.int32),) * 4, device="cpu")
    t2, r2 = T.apply_ops_fast(t, empty)
    assert r2.numel() == 0
    _same(t2, g, "empty batch")


def test_port_oracle_agrees_with_the_serial_engine():
    rng = np.random.default_rng(9)
    t = T.make_graph(64, device="cpu")
    oracle = T.GraphOracle(64)
    for _ in range(4):
        cols = _batch(rng, 24, 30)
        cols[1] = np.abs(cols[1])          # the oracle takes real keys
        cols[2] = np.abs(cols[2])
        t, res = T.apply_ops(t, op_batch_from_numpy(*cols, device="cpu"))
        want = oracle.apply_batch(zip(*(c.tolist() for c in cols)))
        assert res.tolist() == want
    verts, edges = to_networkx_like(t)
    assert set(verts) == set(oracle.ecnt)
    assert set(edges) == oracle.edges


def test_out_of_range_opcodes_follow_each_jax_engine():
    """JAX's engines disagree on an opcode >= 7 (fast: a clean no-op,
    serial: clipped to HasE); the port mirrors each engine as it is."""
    cols = [np.array([J.OP_ADD_V, J.OP_ADD_V, 7, 9], np.int32),
            np.array([1, 2, 1, 2], np.int32), np.array([-1, -1, 2, 1],
                                                       np.int32),
            np.full(4, -1, np.int32)]
    jb, tb = _both(cols)
    for jfn, tfn in ((J.apply_ops_fast, T.apply_ops_fast),
                     (J.apply_ops, T.apply_ops)):
        g, jr = jfn(J.make_graph(8), jb)
        t, tr = tfn(T.make_graph(8, device="cpu"), tb)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        _same(t, g, tfn.__name__)
