"""The port's packed graph state (repro_torch.core.graph) against the JAX
package's: word packing, popcount, ctz, OR reduction, the traversable
predicate and the state helpers, bit for bit (tolerance 0: every output is
an integer or a bool). Words with bit 31 set are the int32 sign bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.graph as jg
import repro_torch.core.graph as tg
from repro.core.bfs import ctz32 as jax_ctz32
from repro_torch.core.bfs import ctz32
from repro_torch.convert import state_from_numpy, state_to_numpy

RNG = np.random.default_rng(7)


def _words(shape):
    w = RNG.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.flat[0] = 0x80000000          # only the sign bit
    w.flat[-1] = 0xFFFFFFFF
    return w


def _t(words_u32):
    return torch.from_numpy(words_u32.view(np.int32).copy())


@pytest.mark.parametrize("v", [6, 40, 200])
def test_pack_unpack_match_jax(v):
    bits = RNG.random((3, v)) < 0.4
    bits[:, min(31, v - 1)] = True
    jw = np.asarray(jg.pack_bits(jnp.asarray(bits)))
    tw = tg.pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(tw, jw)
    back = tg.unpack_bits(_t(jw), v).numpy()
    np.testing.assert_array_equal(back, np.asarray(jg.unpack_bits(
        jnp.asarray(jw), v)))
    np.testing.assert_array_equal(back, bits)


@pytest.mark.parametrize("v", [6, 40, 200])
def test_pack_transpose_and_bit_helpers(v):
    bits = RNG.random((v, v)) < 0.2
    bits[0, v - 1] = True
    jw = np.asarray(jg.pack_bits(jnp.asarray(bits)))
    want = np.asarray(jg.pack_transpose(jnp.asarray(jw), v))
    got = tg.pack_transpose(_t(jw), v).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    for col in (0, 31, v - 1):
        assert tg.bit_word(col) == int(jg.bit_word(col))
        assert np.uint32(tg.bit_mask(col) & 0xFFFFFFFF) == np.uint32(
            jg.bit_mask(col))
        assert bool(tg.get_bit(_t(jw), 0, col)) == bool(
            jg.get_bit(jnp.asarray(jw), 0, col))
    cols = torch.tensor([0, 31, 63, v - 1])
    np.testing.assert_array_equal(
        tg.bit_mask(cols).numpy().view(np.uint32),
        np.asarray(jg.bit_mask(jnp.asarray(cols.numpy()))))


def test_popcount_ctz_or_reduce_match_jax():
    w = _words((5, 13))
    np.testing.assert_array_equal(tg.popcount(_t(w)).numpy(),
                                  np.asarray(jg.popcount(jnp.asarray(w))))
    np.testing.assert_array_equal(ctz32(_t(w)).numpy(),
                                  np.asarray(jax_ctz32(jnp.asarray(w))))
    for axis in (0, 1):
        got = tg.or_reduce(_t(w), axis).numpy().view(np.uint32)
        np.testing.assert_array_equal(
            got, np.asarray(jg.or_reduce(jnp.asarray(w), axis)))
    assert tg.or_reduce(_t(w[:0]), 0).shape == (13,)


def _jax_state(v=200, nv=190, ne=700, seed=3):
    rng = np.random.default_rng(seed)
    ops = [(jg.OP_ADD_V, k) for k in range(nv)]
    ops += [(jg.OP_ADD_E, int(a), int(b))
            for a, b in rng.integers(0, nv, (ne, 2))]
    ops += [(jg.OP_ADD_E, k, 31) for k in range(0, nv, 7)]
    ops += [(jg.OP_REM_V, k) for k in range(0, nv, 23)]
    from repro.core.ops import apply_ops_fast

    g = jg.make_graph(v)
    for i in range(0, len(ops), 256):
        g, _ = apply_ops_fast(g, jg.make_op_batch(ops[i:i + 256], 256))
    return g


def test_state_helpers_match_jax():
    g = _jax_state()
    t = state_from_numpy(*[np.asarray(x) for x in g], device="cpu")
    for a, b in zip(state_to_numpy(t), g):
        np.testing.assert_array_equal(a, np.asarray(b))
    keys = np.array([0, 5, 23, 189, 190, -1, 1000], np.int32)
    np.testing.assert_array_equal(
        tg.find_slots(t, torch.from_numpy(keys)).numpy(),
        np.asarray(jg.find_slots(g, jnp.asarray(keys))))
    for k in (0, 23, 24):
        assert int(tg.find_slot(t, k)) == int(jg.find_slot(g, jnp.int32(k)))
        assert bool(tg.contains_vertex(t, k)) == bool(jg.contains_vertex(g, k))
        for l in (31, 1, 46):
            assert int(tg.contains_edge(t, k, l)) == int(
                jg.contains_edge(g, k, l))
    assert int(tg.num_vertices(t)) == int(jg.num_vertices(g))
    assert int(tg.num_edges(t)) == int(jg.num_edges(g))
    assert tg.to_networkx_like(t) == jg.to_networkx_like(g)
    np.testing.assert_array_equal(tg.version_vector(t).numpy(),
                                  np.asarray(jg.version_vector(g)))
    np.testing.assert_array_equal(t.adj.numpy(), np.asarray(g.adj))
    np.testing.assert_array_equal(t.adj_in.numpy(), np.asarray(g.adj_in))
    assert bool(tg.transpose_invariant(t))
    assert bool(tg.transpose_invariant(t, chunk_words=1))
    grown = tg.grow(t, 300)
    for a, b in zip(state_to_numpy(grown), jg.grow(g, 300)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("budget", [1, 4 * 32 * 7 * 5, 1 << 30])
def test_dense_view_is_built_in_row_chunks(monkeypatch, budget):
    """The dense views unpack in row chunks into one uint8 result (one row
    per chunk, 5 rows, or all at once): the same bits as JAX's views."""
    g = _jax_state()
    t = state_from_numpy(*[np.asarray(x) for x in g], device="cpu")
    monkeypatch.setattr(tg, "_UNPACK_BUDGET", budget)
    for view, want in ((t.adj, g.adj), (t.adj_in, g.adj_in)):
        assert view.dtype == torch.uint8 and view.is_contiguous()
        np.testing.assert_array_equal(view.numpy(), np.asarray(want))


def test_transpose_invariant_catches_a_missing_mirror_bit():
    g = _jax_state(v=70, nv=60, ne=200)
    t = state_from_numpy(*[np.asarray(x) for x in g], device="cpu")
    broken = t.adj_packed.clone()
    broken[3, 1] ^= tg.bit_mask(63)            # column 63: the sign bit
    assert not bool(tg.transpose_invariant(t._replace(
        adj_packed=broken, adj_in_packed=t.adj_in_packed)))


def test_raw_words_and_predicate_forms_agree_on_live_rows():
    """The push kernels read raw words and mask destination liveness in
    their epilogue; the plain path uses ``traversable_packed``. On alive
    source rows the two give the same live bits."""
    g = _jax_state()
    t = state_from_numpy(*[np.asarray(x) for x in g], device="cpu")
    v = t.capacity
    pred = tg.unpack_bits(tg.traversable_packed(
        t.adj_packed, t.valive, t.alive_words), v)
    raw = tg.unpack_bits(t.adj_packed, v) & t.valive[None, :]
    alive_rows = t.valive
    assert torch.equal(pred[alive_rows], raw[alive_rows])
    assert torch.equal(pred, tg.traversable(t.adj, t.valive))
    np.testing.assert_array_equal(
        pred.numpy(), np.asarray(jg.traversable(g.adj, g.valive)))


def test_make_graph_on_the_cpu_matches_jax():
    cpu = tg.make_graph(64, device="cpu")
    for a, b in zip(state_to_numpy(cpu), jg.make_graph(64)):
        np.testing.assert_array_equal(a, np.asarray(b))
