"""The port's plain kernel versions (repro_torch/kernels/*/ref.py, which the
wrappers run for CPU tensors) against the JAX Pallas kernels in interpret
mode and against the JAX ref.py oracles, bit for bit (tolerance 0):

  B1 bfs_multi_step  new, parent (slice-relative) and raw reach_words,
                     including a row slice R < V; without parents
                     (closure mode) new and reach, at Q > 64
  B2 bfs_pull_step   new, parent (global ids), including a row slice;
                     without parents new, at Q > 64
  B3 bfs_step        new, parent and raw reach_words
  B6 bfs_multi_step  dense: new, parent (slice-relative), including a row
                     slice R < V, Q = 65 (two query groups), V not a
                     multiple of 16 and a column every frontier row hits;
                     without parents (closure mode) new alone
  B7 bfs_step        dense: new, parent
  B5 edge_update     packed: adj_packed, ecnt (bit set when vals > 0)
  B9 edge_update     dense: adj, ecnt (vals cast to uint8); both with
                     duplicate targets (the last firing lane wins), masked
                     lanes with out-of-range rows and columns, and V not a
                     multiple of 8 or 32
  B4 label_join       packed: hits, hub (label words with bit 31 set, all-zero
                      OUT rows)
  B8 label_join       dense: hits, hub on the 0/1 slabs, equal to B4 on the
                      packed rows

V is not a multiple of 32 and edges land in column 31 (the int32 sign
bit). The CUDA kernels themselves need the card: the ``cuda``-marked test
runs them against the same plain versions and skips without one
(``python3 chip_smoke.py`` holds them on the card at full size)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bfs_multi_step.kernel import multi_bfs_step_packed_pallas
from repro.kernels.bfs_multi_step.ops import multi_bfs_step as j_b6
from repro.kernels.bfs_multi_step.ref import multi_bfs_step_ref as j_b6_ref
from repro.kernels.bfs_multi_step.ref import multi_bfs_step_packed_ref as j_b1
from repro.kernels.bfs_pull_step.kernel import bfs_pull_step_pallas
from repro.kernels.bfs_pull_step.ref import bfs_pull_step_ref as j_b2
from repro.kernels.bfs_step.kernel import bfs_step_packed_pallas
from repro.kernels.bfs_step.ops import _pick_tile, _pick_word_tile
from repro.kernels.bfs_step.ref import bfs_step_packed_ref as j_b3
from repro.kernels.bfs_step.ops import bfs_step as j_b7
from repro.kernels.bfs_step.ref import bfs_step_ref as j_b7_ref
from repro.core.graph import pack_bits as j_pack_bits
from repro.kernels.edge_update.ops import edge_update as j_b9
from repro.kernels.edge_update.ops import edge_update_packed as j_b5
from repro.kernels.edge_update.ref import edge_update_packed_ref as j_b5_ref
from repro.kernels.edge_update.ref import edge_update_ref as j_b9_ref
from repro_torch.core.graph import pack_bits
from repro_torch.kernels.bfs_multi_step.ops import (multi_bfs_step,
                                                    multi_bfs_step_packed_kernel)
from repro_torch.kernels.bfs_multi_step.ref import (multi_bfs_step_packed_ref,
                                                    multi_bfs_step_ref)
from repro_torch.kernels.bfs_pull_step.ops import bfs_pull_step_rows
from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref
from repro_torch.kernels.bfs_step.ops import bfs_step, bfs_step_packed_kernel
from repro_torch.kernels.bfs_step.ref import bfs_step_packed_ref, bfs_step_ref
from repro_torch.kernels.edge_update.ops import (edge_update,
                                                 edge_update_packed)
from repro_torch.kernels.edge_update.ref import (edge_update_packed_ref,
                                                 edge_update_ref)
from repro.kernels.label_join.kernel import (label_join_packed_pallas,
                                             label_join_pallas)
from repro.kernels.label_join.ref import label_join_packed_ref as j_b4
from repro.kernels.label_join.ref import label_join_ref as j_b8
from repro_torch.kernels.label_join.ops import (label_join, label_join_packed,
                                                label_join_slots)
from repro_torch.kernels.label_join.ref import (label_join_packed_ref,
                                                label_join_ref,
                                                label_join_slots_ref)


def _case(v, q, density, seed):
    rng = np.random.default_rng(seed)
    adj = rng.random((v, v)) < density
    adj[0, 31 % v] = adj[v // 2, 31 % v] = True
    w = -(-v // 32)
    padded = np.zeros((v, w * 32), bool)
    padded[:, :v] = adj
    words = np.packbits(padded, axis=1, bitorder="little").view(np.uint32)
    in_padded = np.zeros((v, w * 32), bool)
    in_padded[:, :v] = adj.T
    in_words = np.packbits(in_padded, axis=1,
                           bitorder="little").view(np.uint32)
    fr = rng.random((q, v)) < 0.2
    fr[0, 0] = True
    if q > 1:
        fr[-1] = False                       # an empty frontier
    alive = rng.random(v) < 0.85
    vis = fr | (rng.random((q, v)) < 0.25)
    return words, in_words, fr, alive, vis


def _t(x):
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x.copy())


def _pad(x, vc):
    out = np.zeros(x.shape[:-1] + (vc,), np.int32)
    out[..., :x.shape[-1]] = x
    return jnp.asarray(out)


def _u32(t):
    return t.numpy().view(np.uint32)


CASES = [(40, 1, 0.0), (40, 5, 0.3), (200, 5, 0.05), (200, 1, 0.3)]


@pytest.mark.parametrize("v,q,density", CASES)
def test_b1_push_plain_matches_pallas(v, q, density):
    words, _, fr, alive, vis = _case(v, q, density, seed=v + q)
    w = words.shape[1]
    vc = w * 32
    for r0, r1 in ((0, v), (8, 8 + (v - 8) // 2 // 8 * 8)):   # full, slice
        args = (jnp.asarray(fr[:, r0:r1], jnp.float32),
                jnp.asarray(words[r0:r1]), _pad(alive, vc), _pad(vis, vc))
        pallas = multi_bfs_step_packed_pallas(
            *args, tr=_pick_tile(r1 - r0), tw=_pick_word_tile(w),
            interpret=True)
        oracle = j_b1(*args)
        new, parent, reach = multi_bfs_step_packed_ref(
            _t(fr[:, r0:r1]), _t(words[r0:r1]), _t(alive), _t(vis))
        for want in (pallas, oracle):
            np.testing.assert_array_equal(new.numpy(),
                                          np.asarray(want[0])[:, :v] > 0)
            np.testing.assert_array_equal(parent.numpy(),
                                          np.asarray(want[1])[:, :v])
            np.testing.assert_array_equal(_u32(reach), np.asarray(want[2]))
        # the CPU wrapper takes exactly this plain version
        got = multi_bfs_step_packed_kernel(
            _t(fr[:, r0:r1]), _t(words[r0:r1]), _t(alive), _t(vis))
        for a, b in zip(got, (new, parent, reach)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("v,q,density", CASES)
def test_b2_pull_plain_matches_pallas(v, q, density):
    _, in_words, fr, alive, vis = _case(v, q, density, seed=2 * v + q)
    fw = np.asarray(pack_bits(torch.from_numpy(fr & alive)).numpy()
                    ).view(np.uint32)
    for r0, r1 in ((0, v), (8, 8 + (v - 8) // 2 // 8 * 8)):
        args = (jnp.asarray(fw), jnp.asarray(in_words[r0:r1]),
                jnp.asarray(alive[r0:r1], jnp.int32),
                jnp.asarray(vis[:, r0:r1], jnp.int32))
        pallas = bfs_pull_step_pallas(*args, tr=_pick_tile(r1 - r0),
                                      interpret=True)
        oracle = j_b2(*args)
        targs = (_t(fw), _t(in_words[r0:r1]), _t(alive[r0:r1]),
                 _t(vis[:, r0:r1]))
        new, parent = bfs_pull_step_ref(*targs)
        for want in (pallas, oracle):
            np.testing.assert_array_equal(new.numpy(), np.asarray(want[0]) > 0)
            np.testing.assert_array_equal(parent.numpy(), np.asarray(want[1]))
        for a, b in zip(bfs_pull_step_rows(*targs), (new, parent)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("v,density", [(40, 0.3), (200, 0.05)])
def test_b3_single_push_plain_matches_pallas(v, density):
    words, _, fr, alive, vis = _case(v, 1, density, seed=3 * v)
    w = words.shape[1]
    vc = w * 32
    args = (jnp.asarray(fr[0], jnp.float32), jnp.asarray(words),
            _pad(alive, vc), _pad(vis[0], vc))
    pallas = bfs_step_packed_pallas(*args, tr=_pick_tile(v),
                                    tw=_pick_word_tile(w), interpret=True)
    oracle = j_b3(*args)
    targs = (_t(fr[0]), _t(words), _t(alive), _t(vis[0]))
    new, parent, reach = bfs_step_packed_ref(*targs)
    for want in (pallas, oracle):
        np.testing.assert_array_equal(new.numpy(), np.asarray(want[0])[:v] > 0)
        np.testing.assert_array_equal(parent.numpy(), np.asarray(want[1])[:v])
        np.testing.assert_array_equal(_u32(reach), np.asarray(want[2]))
    for a, b in zip(bfs_step_packed_kernel(*targs), (new, parent, reach)):
        assert torch.equal(a, b)


def _single_case(v, frontier, seed):
    """B3 inputs on V not a multiple of 32: a sparse graph in which rows 3
    and 33 set only bit 31 of their words (the int32 sign bit) and row 1
    sets a bit in every word, and the named frontier."""
    rng = np.random.default_rng(seed)
    adj = rng.random((v, v)) < 0.05
    adj[[3, 33]] = False
    adj[3, 31::32] = adj[33, 31::32] = True
    adj[1, ::32] = True
    w = -(-v // 32)
    padded = np.zeros((v, w * 32), bool)
    padded[:, :v] = adj
    words = np.packbits(padded, axis=1, bitorder="little").view(np.uint32)
    fr = np.zeros(v, bool)
    fr[{"rows 31 mod 32": np.arange(31, v, 32), "empty": [],
        "every row": np.arange(v), "bit-31 rows": [3, 33]}[frontier]] = True
    alive = rng.random(v) < 0.85
    vis = fr | (rng.random(v) < 0.25)
    alive[31], vis[31] = True, fr[31]
    return words, fr, alive, vis


SINGLE_FRONTIERS = ["rows 31 mod 32", "empty", "every row", "bit-31 rows"]


@pytest.mark.parametrize("frontier", SINGLE_FRONTIERS)
@pytest.mark.parametrize("v", [61, 95])
def test_b3_single_push_frontiers_match_pallas(v, frontier):
    """B3's plain version (what its wrapper runs on the CPU) against the
    Pallas kernel in interpret mode on the frontiers the one-launch kernel
    lists in its own way; reach bits at columns >= V stay zero."""
    words, fr, alive, vis = _single_case(v, frontier, seed=v)
    w = words.shape[1]
    vc = w * 32
    args = (jnp.asarray(fr, jnp.float32), jnp.asarray(words),
            _pad(alive, vc), _pad(vis, vc))
    pallas = bfs_step_packed_pallas(*args, tr=_pick_tile(v),
                                    tw=_pick_word_tile(w), interpret=True)
    targs = (_t(fr), _t(words), _t(alive), _t(vis))
    new, parent, reach = bfs_step_packed_kernel(*targs)
    np.testing.assert_array_equal(new.numpy(), np.asarray(pallas[0])[:v] > 0)
    np.testing.assert_array_equal(parent.numpy(), np.asarray(pallas[1])[:v])
    np.testing.assert_array_equal(_u32(reach), np.asarray(pallas[2]))
    assert _u32(reach)[-1] >> (v % 32) == 0          # columns >= V
    assert new.shape == parent.shape == (v,)
    if frontier == "bit-31 rows":     # the smaller of rows 3 and 33 wins
        assert new[31] and new.numpy()[np.arange(v) % 32 != 31].sum() == 0
        assert set(parent.numpy()[new.numpy()].tolist()) == {3}


NO_PARENT_CASES = [(75, 70, 0.1), (200, 130, 0.05), (40, 65, 0.3)]


@pytest.mark.parametrize("v,q,density", NO_PARENT_CASES)
def test_b1_without_parents_matches_with_parents_and_pallas(v, q, density):
    """Closure mode: B1's plain version with ``parents=False`` gives the
    same new and reach as with parents and as the Pallas kernel, and None
    in the parent's place (Q > 64, V not a multiple of 32, edges in
    column 31)."""
    words, _, fr, alive, vis = _case(v, q, density, seed=5 * v + q)
    w = words.shape[1]
    vc = w * 32
    for r0, r1 in ((0, v), (8, 8 + (v - 8) // 2 // 8 * 8)):
        args = (_t(fr[:, r0:r1]), _t(words[r0:r1]), _t(alive), _t(vis))
        new, parent, reach = multi_bfs_step_packed_ref(*args, parents=False)
        assert parent is None
        with_p = multi_bfs_step_packed_ref(*args)
        assert torch.equal(new, with_p[0]) and torch.equal(reach, with_p[2])
        pallas = multi_bfs_step_packed_pallas(
            jnp.asarray(fr[:, r0:r1], jnp.float32), jnp.asarray(words[r0:r1]),
            _pad(alive, vc), _pad(vis, vc), tr=_pick_tile(r1 - r0),
            tw=_pick_word_tile(w), interpret=True)
        np.testing.assert_array_equal(new.numpy(),
                                      np.asarray(pallas[0])[:, :v] > 0)
        np.testing.assert_array_equal(_u32(reach), np.asarray(pallas[2]))
        got = multi_bfs_step_packed_kernel(*args, parents=False)
        assert got[1] is None
        assert torch.equal(got[0], new) and torch.equal(got[2], reach)


@pytest.mark.parametrize("v,q,density", NO_PARENT_CASES)
def test_b2_without_parents_matches_with_parents_and_pallas(v, q, density):
    """B2's plain version with ``parents=False``: the same new as with
    parents and as the Pallas kernel, None in the parent's place."""
    _, in_words, fr, alive, vis = _case(v, q, density, seed=7 * v + q)
    fw = np.asarray(pack_bits(torch.from_numpy(fr & alive)).numpy()
                    ).view(np.uint32)
    for r0, r1 in ((0, v), (8, 8 + (v - 8) // 2 // 8 * 8)):
        targs = (_t(fw), _t(in_words[r0:r1]), _t(alive[r0:r1]),
                 _t(vis[:, r0:r1]))
        new, parent = bfs_pull_step_ref(*targs, parents=False)
        assert parent is None
        assert torch.equal(new, bfs_pull_step_ref(*targs)[0])
        pallas = bfs_pull_step_pallas(
            jnp.asarray(fw), jnp.asarray(in_words[r0:r1]),
            jnp.asarray(alive[r0:r1], jnp.int32),
            jnp.asarray(vis[:, r0:r1], jnp.int32), tr=_pick_tile(r1 - r0),
            interpret=True)
        np.testing.assert_array_equal(new.numpy(), np.asarray(pallas[0]) > 0)
        got = bfs_pull_step_rows(*targs, parents=False)
        assert got[1] is None and torch.equal(got[0], new)


def test_bool_wrappers_pass_parents_through():
    """The drop-ins of core.bfs hand ``parents`` to the kernel wrappers."""
    from repro_torch.kernels.bfs_multi_step.ops import multi_bfs_step_packed
    from repro_torch.kernels.bfs_pull_step.ops import multi_bfs_pull_step

    words, in_words, fr, alive, vis = _case(75, 70, 0.1, seed=3)
    push = (_t(fr), _t(words), _t(alive), _t(vis))
    pull = (_t(fr), _t(in_words), _t(alive), _t(vis))
    for fn, args in ((multi_bfs_step_packed, push),
                     (multi_bfs_pull_step, pull)):
        new, parent = fn(*args, parents=False)
        assert parent is None
        with_p = fn(*args)
        assert torch.equal(new, with_p[0]) and with_p[1] is not None


def test_plain_versions_chunk_without_changing_results():
    """The plain versions bound their transient by processing rows in
    ascending chunks; a tiny budget (one row per chunk) gives the same
    answer."""
    words, in_words, fr, alive, vis = _case(200, 5, 0.1, seed=11)
    args = (_t(fr), _t(words), _t(alive), _t(vis))
    for a, b in zip(multi_bfs_step_packed_ref(*args),
                    multi_bfs_step_packed_ref(*args, budget=1)):
        assert torch.equal(a, b)
    fw = pack_bits(torch.from_numpy(fr & alive))
    pargs = (fw, _t(in_words), _t(alive), _t(vis))
    for a, b in zip(bfs_pull_step_ref(*pargs),
                    bfs_pull_step_ref(*pargs, budget=1)):
        assert torch.equal(a, b)
    dargs = (_t(fr), _dense(words, 200), _t(alive), _t(vis))
    for a, b in zip(multi_bfs_step_ref(*dargs),
                    multi_bfs_step_ref(*dargs, budget=1)):
        assert torch.equal(a, b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("v,q,density", CASES)
def test_cuda_kernels_match_plain_versions(cuda_device, v, q, density):
    words, in_words, fr, alive, vis = _case(v, q, density, seed=v * q)
    d = cuda_device
    args = [_t(x).to(d) for x in (fr, words, alive, vis)]
    for a, b in zip(multi_bfs_step_packed_kernel(*args),
                    multi_bfs_step_packed_ref(*args)):
        assert torch.equal(a, b)
    single = [args[0][0], args[1], args[2], args[3][0]]
    for a, b in zip(bfs_step_packed_kernel(*single),
                    bfs_step_packed_ref(*single)):
        assert torch.equal(a, b)
    fw = pack_bits(args[0] & args[2][None])
    pargs = [fw, _t(in_words).to(d), args[2], args[3]]
    for a, b in zip(bfs_pull_step_rows(*pargs), bfs_pull_step_ref(*pargs)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("frontier", SINGLE_FRONTIERS)
@pytest.mark.parametrize("v", [61, 95, 4100])
def test_cuda_b3_single_push_matches_plain(cuda_device, v, frontier):
    words, fr, alive, vis = _single_case(v, frontier, seed=v + 1)
    args = [_t(x).to(cuda_device) for x in (fr, words, alive, vis)]
    for a, b in zip(bfs_step_packed_kernel(*args), bfs_step_packed_ref(*args)):
        assert torch.equal(a, b)


def _labels(q, l, density, seed):
    """0/1 int32 OUT/IN slabs [Q, L] with a common landmark in column 31
    (the int32 sign bit of word 0) and an all-zero OUT row."""
    rng = np.random.default_rng(seed)
    a = (rng.random((q, l)) < density).astype(np.int32)
    b = (rng.random((q, l)) < density).astype(np.int32)
    if l > 31:
        a[0, 31] = b[0, 31] = 1
    if q > 1:
        a[-1] = 0
    return a, b


def _pack(rows):
    return pack_bits(torch.from_numpy(rows != 0))


LABEL_CASES = [(1, 31, 0.3), (5, 32, 0.0), (8, 64, 0.3), (13, 130, 0.01),
               (16, 256, 0.3)]


@pytest.mark.parametrize("q,l,density", LABEL_CASES)
def test_label_join_plain_matches_pallas_and_jax_refs(q, l, density):
    a, b = _labels(q, l, density, seed=q * l)
    pa, pb = _pack(a), _pack(b)
    dense = label_join_ref(torch.from_numpy(a), torch.from_numpy(b))
    packed = label_join_packed_ref(pa, pb)
    ja, jb = jnp.asarray(pa.numpy().view(np.uint32)), jnp.asarray(
        pb.numpy().view(np.uint32))
    wants = [j_b8(jnp.asarray(a), jnp.asarray(b)), j_b4(ja, jb)]
    if q % 8 == 0:       # the Pallas kernels take padded tiles
        wants.append(label_join_packed_pallas(ja, jb, tq=q, tw=ja.shape[1]))
        if l % 128 == 0:
            wants.append(label_join_pallas(jnp.asarray(a), jnp.asarray(b),
                                           tq=q, tl=128))
    for want in wants:
        for got in (dense, packed):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the CPU wrappers take exactly these plain versions
    for x, y in zip(label_join(torch.from_numpy(a), torch.from_numpy(b)),
                    dense):
        assert torch.equal(x, y)
    for x, y in zip(label_join_packed(pa, pb), packed):
        assert torch.equal(x, y)


def test_label_join_plain_handles_the_sign_bit_and_empty_shapes():
    top = torch.tensor([[-2**31, 0], [-2**31 | 1, 0]], dtype=torch.int32)
    hits, hub = label_join_packed_ref(top, torch.tensor(
        [[-2**31, 0], [-2**31, 0]], dtype=torch.int32))
    assert hits.tolist() == [1, 1] and hub.tolist() == [31, 31]
    for fn in (label_join_ref, label_join_packed_ref):
        hits, hub = fn(torch.zeros((3, 0), dtype=torch.int32),
                       torch.zeros((3, 0), dtype=torch.int32))
        assert hits.tolist() == [0, 0, 0] and hub.tolist() == [-1, -1, -1]


@pytest.mark.cuda
@pytest.mark.parametrize("q,l,density", LABEL_CASES + [(1000, 1030, 0.3)])
def test_cuda_label_join_kernels_match_plain_versions(cuda_device, q, l,
                                                      density):
    a, b = _labels(q, l, density, seed=q + l)
    ta = torch.from_numpy(a).to(cuda_device)
    tb = torch.from_numpy(b).to(cuda_device)
    pa, pb = pack_bits(ta != 0), pack_bits(tb != 0)
    dense = label_join(ta, tb)
    packed = label_join_packed(pa, pb)
    for got in (dense, packed):
        for x, y in zip(got, label_join_ref(ta, tb)):
            assert torch.equal(x, y)


# ----------------------------------------------------------------------------
# B6 / B7: the dense supersteps (JAX's ops wrappers run the Pallas kernels
# in interpret mode). V <= 64: interpret mode is slow.
# ----------------------------------------------------------------------------
def _dense(words, v):
    """uint8[R, v] adjacency of packed uint32 words."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=1,
                         bitorder="little")[:, :v]
    return torch.from_numpy(np.ascontiguousarray(bits))


# (64, 65): a second query group of one query; (45, 3): V not a multiple
# of 16 (the kernel's byte-wise tail); (48, 4, 1.0): every column hit by
# every frontier row
DENSE_CASES = [(40, 1, 0.0), (40, 5, 0.3), (64, 5, 0.05), (64, 1, 0.3),
               (64, 65, 0.05), (45, 3, 0.05), (48, 4, 1.0)]


@pytest.mark.parametrize("v,q,density", DENSE_CASES)
def test_b6_dense_plain_matches_pallas(v, q, density):
    """Also without parents (closure mode): ``new`` alone, ``None`` in
    place of the parent."""
    words, _, fr, alive, vis = _case(v, q, density, seed=5 * v + q)
    adj = _dense(words, v)
    for r0, r1 in ((0, v), (8, 8 + (v - 8) // 2)):     # full, a row slice
        a = adj[r0:r1].contiguous()
        targs = (_t(fr[:, r0:r1]), a, _t(alive), _t(vis))
        new, parent = multi_bfs_step_ref(*targs)
        pallas = j_b6(jnp.asarray(fr[:, r0:r1]), jnp.asarray(a.numpy()),
                      jnp.asarray(alive), jnp.asarray(vis))
        oracle = j_b6_ref(jnp.asarray(fr[:, r0:r1], jnp.float32),
                          jnp.asarray(a.numpy()),
                          jnp.asarray(alive, jnp.int32),
                          jnp.asarray(vis, jnp.int32))
        for want in (pallas, oracle):
            np.testing.assert_array_equal(new.numpy(), np.asarray(want[0]) > 0)
            np.testing.assert_array_equal(parent.numpy(), np.asarray(want[1]))
        # column 31 is reached from row 0 of a full frontier 0
        if r0 == 0 and alive[31] and not vis[0, 31]:
            assert bool(new[0, 31]) and int(parent[0, 31]) == 0
        for x, y in zip(multi_bfs_step(*targs), (new, parent)):
            assert torch.equal(x, y)
        for got in (multi_bfs_step_ref(*targs, parents=False),
                    multi_bfs_step(*targs, parents=False)):
            assert got[1] is None
            np.testing.assert_array_equal(got[0].numpy(),
                                          np.asarray(pallas[0]) > 0)


@pytest.mark.parametrize("v,density", [(40, 0.3), (64, 0.05), (45, 1.0)])
def test_b7_dense_single_plain_matches_pallas(v, density):
    words, _, fr, alive, vis = _case(v, 1, density, seed=7 * v)
    adj = _dense(words, v)
    targs = (_t(fr[0]), adj, _t(alive), _t(vis[0]))
    new, parent = bfs_step_ref(*targs)
    pallas = j_b7(jnp.asarray(fr[0]), jnp.asarray(adj.numpy()),
                  jnp.asarray(alive), jnp.asarray(vis[0]))
    oracle = j_b7_ref(jnp.asarray(fr[0], jnp.float32),
                      jnp.asarray(adj.numpy()), jnp.asarray(alive, jnp.int32),
                      jnp.asarray(vis[0], jnp.int32))
    for want in (pallas, oracle):
        np.testing.assert_array_equal(new.numpy(), np.asarray(want[0]) > 0)
        np.testing.assert_array_equal(parent.numpy(), np.asarray(want[1]))
    for x, y in zip(bfs_step(*targs), (new, parent)):
        assert torch.equal(x, y)


# ----------------------------------------------------------------------------
# B5 / B9: the lane-ordered edge writes
# ----------------------------------------------------------------------------
def _lanes(v, b, seed, vals_from):
    """Edge-write lanes with duplicate targets, a column-31 target, masked
    lanes (mask <= 0) parked out of range, and ``vals`` from ``vals_from``."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((v, v)) < 0.1).astype(np.uint8)
    ecnt = rng.integers(0, 5, v).astype(np.int32)
    rows = rng.integers(0, v, b).astype(np.int32)
    cols = rng.integers(0, v, b).astype(np.int32)
    rows[-3:], cols[-3:] = rows[0], cols[0]        # four lanes, one target
    cols[1] = 31 % v
    vals = rng.choice(vals_from, b).astype(np.int32)
    mask = rng.choice([0, 1, 3, -2], b).astype(np.int32)
    mask[0] = mask[-1] = 1
    off = mask <= 0
    rows[off & (rng.random(b) < 0.5)] = 10**6
    cols[off & (rng.random(b) < 0.5)] = -10**6
    return adj, ecnt, rows, cols, vals, mask


EDGE_CASES = [(20, 8), (45, 33), (64, 40)]
IN_RANGE_VALS = [0, 1, 2, 7, 255]        # where the JAX refs agree with
ANY_VALS = IN_RANGE_VALS + [256, -1]     # the JAX kernels


def _packed_words(adj):
    return np.asarray(j_pack_bits(jnp.asarray(adj > 0)))


@pytest.mark.parametrize("v,b", EDGE_CASES)
@pytest.mark.parametrize("vals_from", [IN_RANGE_VALS, ANY_VALS])
def test_b9_dense_edge_update_plain_matches_jax(v, b, vals_from):
    case = _lanes(v, b, seed=v + b, vals_from=vals_from)
    want = [j_b9(*[jnp.asarray(x) for x in case])]
    if vals_from is IN_RANGE_VALS:
        want.append(j_b9_ref(*[jnp.asarray(x) for x in case]))
    t = [torch.from_numpy(x.copy()) for x in case]
    adj, ecnt = edge_update_ref(*t)
    for w in want:
        np.testing.assert_array_equal(adj.numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(ecnt.numpy(), np.asarray(w[1]))
    for x, y in zip(edge_update(*t), (adj, ecnt)):
        assert torch.equal(x, y)
    for x, y in zip(t, case):                              # not written
        assert torch.equal(x, _t(y))


@pytest.mark.parametrize("v,b", EDGE_CASES)
@pytest.mark.parametrize("vals_from", [IN_RANGE_VALS, ANY_VALS])
def test_b5_packed_edge_update_plain_matches_jax(v, b, vals_from):
    adj, *rest = _lanes(v, b, seed=2 * v + b, vals_from=vals_from)
    words = _packed_words(adj)
    case = [words] + rest
    want = [j_b5(*[jnp.asarray(x) for x in case])]
    if vals_from is IN_RANGE_VALS:
        want.append(j_b5_ref(*[jnp.asarray(x) for x in case]))
    t = [_t(words)] + [torch.from_numpy(x.copy()) for x in rest]
    got, ecnt = edge_update_packed_ref(*t)
    for w in want:
        np.testing.assert_array_equal(_u32(got), np.asarray(w[0]))
        np.testing.assert_array_equal(ecnt.numpy(), np.asarray(w[1]))
    for x, y in zip(edge_update_packed(*t), (got, ecnt)):
        assert torch.equal(x, y)
    for x, y in zip(t, case):                              # not written
        assert torch.equal(x, _t(y))


def test_edge_update_last_lane_wins_on_the_sign_bit():
    """Duplicates of one target apply in lane order, in the sign bit too;
    every firing lane bumps ecnt, a masked lane does nothing."""
    words = torch.zeros((4, 2), dtype=torch.int32)
    ecnt = torch.zeros((4,), dtype=torch.int32)
    lanes = [torch.tensor(x, dtype=torch.int32) for x in
             ([1, 1, 1, 2, 99], [31, 31, 31, 63, -5], [1, 0, 1, 1, 1],
              [1, 1, 1, 1, 0])]
    got, e = edge_update_packed(words, ecnt, *lanes)
    assert _u32(got)[1, 0] == 1 << 31 and _u32(got)[2, 1] == 1 << 31
    assert e.tolist() == [0, 3, 1, 0]
    dense, e = edge_update(torch.zeros((4, 64), dtype=torch.uint8), ecnt,
                           *lanes[:2], torch.tensor([7, 0, 300, 1, 1],
                                                    dtype=torch.int32),
                           lanes[3])
    assert int(dense[1, 31]) == 300 % 256 and e.tolist() == [0, 3, 1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("v,q,density", DENSE_CASES)
def test_cuda_dense_and_edge_kernels_match_plain_versions(cuda_device, v, q,
                                                          density):
    words, _, fr, alive, vis = _case(v, q, density, seed=v * q + 1)
    d = cuda_device
    args = [_t(fr).to(d), _dense(words, v).to(d), _t(alive).to(d),
            _t(vis).to(d)]
    for a, b in zip(multi_bfs_step(*args), multi_bfs_step_ref(*args)):
        assert torch.equal(a, b)
    sl = [args[0][:, 3:].contiguous(), args[1][3:]] + args[2:]  # odd row
    for a, b in zip(multi_bfs_step(*sl), multi_bfs_step_ref(*sl)):
        assert torch.equal(a, b)
    for x in (args, sl):
        new, none = multi_bfs_step(*x, parents=False)
        assert none is None and torch.equal(new, multi_bfs_step_ref(*x)[0])
    single = [args[0][0], args[1], args[2], args[3][0]]
    for a, b in zip(bfs_step(*single), bfs_step_ref(*single)):
        assert torch.equal(a, b)
    adj, *rest = _lanes(v, 64, seed=v, vals_from=ANY_VALS)
    t = [torch.from_numpy(x).to(d) for x in rest]
    dense = torch.from_numpy(adj).to(d)
    for a, b in zip(edge_update(dense, *t), edge_update_ref(dense, *t)):
        assert torch.equal(a, b)
    packed = _t(_packed_words(adj)).to(d)
    for a, b in zip(edge_update_packed(packed, *t),
                    edge_update_packed_ref(packed, *t)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("q,l", [(0, 64), (1, 31), (64, 1024), (1000, 1030)])
def test_cuda_label_join_slots_matches_plain(cuda_device, q, l):
    """B4 by slot against its plain version: slots of -1 and past the end,
    dead endpoints, rows with the sign bit."""
    rng = np.random.default_rng(q + l)
    v = 300
    labels = []
    for _ in range(2):
        bits = rng.random((v, l)) < 0.05
        bits[::7, min(31, l - 1)] = True
        labels.append(pack_bits(torch.from_numpy(bits)).to(cuda_device))
    alive = torch.from_numpy(rng.random(v) < 0.8).to(cuda_device)
    src, dst = (torch.from_numpy(rng.integers(-1, v + 3, q).astype(
        np.int32)).to(cuda_device) for _ in range(2))
    args = (*labels, alive, src, dst)
    for x, y in zip(label_join_slots(*args), label_join_slots_ref(*args)):
        assert torch.equal(x, y)
