"""The port's plain kernel versions (repro_torch/kernels/*/ref.py, which the
wrappers run for CPU tensors) against the JAX Pallas kernels in interpret
mode and against the JAX ref.py oracles, bit for bit (tolerance 0):

  B1 bfs_multi_step  new, parent (slice-relative) and raw reach_words,
                     including a row slice R < V
  B2 bfs_pull_step   new, parent (global ids), including a row slice
  B3 bfs_step        new, parent and raw reach_words
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
from repro.kernels.bfs_multi_step.ref import multi_bfs_step_packed_ref as j_b1
from repro.kernels.bfs_pull_step.kernel import bfs_pull_step_pallas
from repro.kernels.bfs_pull_step.ref import bfs_pull_step_ref as j_b2
from repro.kernels.bfs_step.kernel import bfs_step_packed_pallas
from repro.kernels.bfs_step.ops import _pick_tile, _pick_word_tile
from repro.kernels.bfs_step.ref import bfs_step_packed_ref as j_b3
from repro_torch.core.graph import pack_bits
from repro_torch.kernels.bfs_multi_step.ops import multi_bfs_step_packed_kernel
from repro_torch.kernels.bfs_multi_step.ref import multi_bfs_step_packed_ref
from repro_torch.kernels.bfs_pull_step.ops import bfs_pull_step_rows
from repro_torch.kernels.bfs_pull_step.ref import bfs_pull_step_ref
from repro_torch.kernels.bfs_step.ops import bfs_step_packed_kernel
from repro_torch.kernels.bfs_step.ref import bfs_step_packed_ref
from repro.kernels.label_join.kernel import (label_join_packed_pallas,
                                             label_join_pallas)
from repro.kernels.label_join.ref import label_join_packed_ref as j_b4
from repro.kernels.label_join.ref import label_join_ref as j_b8
from repro_torch.kernels.label_join.ops import label_join, label_join_packed
from repro_torch.kernels.label_join.ref import (label_join_packed_ref,
                                                label_join_ref)


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
