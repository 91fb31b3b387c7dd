"""The port's LM (repro_torch.configs, repro_torch.models) against the JAX
package's (repro.configs, repro.models) on the CPU: the five dense-trunk
smoke configs (qwen2-1.5b, qwen3-4b, olmo-1b, gemma2-27b with its window of
16, internvl2-76b with its stub patch embeddings) run on JAX's
``Model.init`` params through ``convert.lm_params_from_numpy``, on the same
numpy-seeded tokens. Held: ``forward`` logits, ``prefill``'s last logits
and caches, ``cache_from_prefill`` above and below the prompt (the ring
of gemma2's local layers), 8 teacher-forced ``decode_step``s past the
window, and ``loss_and_metrics``; one bf16 case; the configs field for
field; every config building on ported layer kinds; the port's own init.
The other families are held in tests/test_torch_lm_families.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models.model import build_model as jax_build
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.models.model import build_model

DENSE = ("qwen2-1.5b", "qwen3-4b", "olmo-1b", "gemma2-27b", "internvl2-76b")
# f32 on both sides; the two differ only in the order of float sums
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, P = 2, 32, 24          # batch, tokens, prompt of the bf16 decode


@functools.lru_cache(maxsize=None)
def _jax_side(arch, dtype):
    """(config, model, params, jitted decode_step) of the JAX package,
    shared by the tests of one arch (eager JAX decodes ~10x slower)."""
    jcfg = dataclasses.replace(JC.get_config(arch).smoke(), dtype=dtype)
    jm = jax_build(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(1)), jax.jit(jm.decode_step)


def _pair(arch, dtype="float32"):
    """The JAX side and the port's model on the same params."""
    jcfg, jm, jp, _ = _jax_side(arch, dtype)
    tcfg = dataclasses.replace(TC.get_config(arch).smoke(), dtype=dtype)
    tp = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return jcfg, jm, jp, build_model(tcfg), tp


def _batches(cfg, n_text, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, n_text)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.n_vis_tokens:
        vis = rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model)).astype(
            np.float32)
        jb["vis_embeds"] = jnp.asarray(vis)
        tb["vis_embeds"] = torch.from_numpy(vis)
    return jb, tb


def _close(t, j, what, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               err_msg=what, **tol)


def _cache_leaves(caches):
    """The port's caches in jax.tree.leaves order."""
    return [x for group in caches for li in sorted(group) for x in group[li]]


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_match_jax(arch):
    cfg, jm, jp, tm, tp = _pair(arch)
    jb, tb = _batches(cfg, S - cfg.n_vis_tokens)
    jl, _, _ = jm.forward(jp, jb)
    tl, caches, aux = tm.forward(tp, tb)
    assert caches is None and tl.dtype == torch.float32
    assert tl.shape == (B, S - cfg.n_vis_tokens, cfg.vocab)
    _close(tl, jl, f"{arch} forward logits")
    jlast, _, _ = jm.forward(jp, jb, last_only=True)
    tlast, _, _ = tm.forward(tp, tb, last_only=True)
    _close(tlast, jlast, f"{arch} last_only logits")
    jloss, jmet = jm.loss_and_metrics(jp, jb)
    tloss, tmet = tm.loss_and_metrics(tp, tb)
    _close(tloss, jloss, f"{arch} loss")
    assert sorted(tmet) == sorted(jmet) == ["aux", "loss"]
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_caches_match_jax(arch):
    cfg, jm, jp, tm, tp = _pair(arch)
    jb, tb = _batches(cfg, P)
    jlast, jc = jm.prefill(jp, jb)
    tlast, tc = tm.prefill(tp, tb)
    _close(tlast, jlast, f"{arch} prefill logits")
    jleaves, tleaves = jax.tree.leaves(jc), _cache_leaves(tc)
    assert [t.shape for t in tleaves] == [tuple(j.shape) for j in jleaves]
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        _close(t, j, f"{arch} prefill cache leaf {i}")


@pytest.mark.parametrize("cache_len", [64, 12], ids=["above", "below"])
@pytest.mark.parametrize("arch", DENSE)
def test_cache_from_prefill_and_decode_match_jax(arch, cache_len):
    """cache_len 64 pads every layer; 12 is below the prompt, so gemma2's
    local layers (window 16) keep a ring of 12 and its global layers, like
    every other arch's, are clamped as JAX's dynamic_update_slice clamps.
    8 teacher-forced steps run past the window."""
    cfg, jm, jp, tm, tp = _pair(arch)
    n_text = S - cfg.n_vis_tokens
    jb, tb = _batches(cfg, n_text)
    jfull, _, _ = jm.forward(jp, jb)
    p = n_text - 8
    jpb, tpb = dict(jb), dict(tb)
    jpb["tokens"], tpb["tokens"] = jb["tokens"][:, :p], tb["tokens"][:, :p]
    _, jc = jm.prefill(jp, jpb)
    _, tc = tm.prefill(tp, tpb)
    jc = jm.cache_from_prefill(jc, cache_len)
    tc = tm.cache_from_prefill(tc, cache_len)
    for i, (t, j) in enumerate(zip(_cache_leaves(tc), jax.tree.leaves(jc),
                                   strict=True)):
        assert t.shape == tuple(j.shape)
        _close(t, j, f"{arch} decode cache leaf {i}")
    off = cfg.n_vis_tokens
    for t in range(p, n_text):
        jl, jc = _jax_side(arch, "float32")[3](jp, jc, jb["tokens"][:, t],
                                               jnp.int32(t + off))
        tl, tc = tm.decode_step(tp, tc, tb["tokens"][:, t], t + off)
        _close(tl, jl, f"{arch} decode logits at {t}")
    for i, (t, j) in enumerate(zip(_cache_leaves(tc), jax.tree.leaves(jc))):
        _close(t, j, f"{arch} cache leaf {i} after decode")
    if cache_len > S:    # a padded cache decodes what the full forward says
        _close(tl, jfull[:, -1], f"{arch} decode against forward",
               tol=dict(rtol=5e-3, atol=5e-3))


@pytest.mark.parametrize("chunk", [8, 7])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-27b"])
def test_online_softmax_over_many_kv_chunks_matches_jax(arch, chunk):
    """The prefill's scan over KV chunks (one chunk below 1,024 tokens in
    the other tests): 40 keys in chunks of 8, or of 5 (the largest divisor
    of 40 up to 7); gemma2's window of 16 and attention softcap."""
    from repro.models.attention import _attend_chunked as jax_attend
    from repro_torch.models.attention import _attend_chunked

    cfg = TC.get_config(arch).smoke()
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 40, cfg.n_heads, cfg.hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, 40, cfg.n_kv, cfg.hd)).astype(np.float32)
            for _ in range(2))
    for window in sorted({0, cfg.sliding_window}):
        want = jax_attend(cfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, window=window, chunk=chunk)
        got = _attend_chunked(cfg, torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window, chunk=chunk)
        _close(got, want, f"{arch} window {window} chunk {chunk}")


def test_bf16_qwen2_matches_jax_within_bf16_rounding():
    """qwen2's smoke config in bf16: both sides round every product and
    activation to bf16 (8 mantissa bits), at places that differ by the
    order of their f32 sums. Measured max |diff| of the logits is ~0.01
    against a logit scale of ~0.16; the tolerance is 0.03 absolute.
    Greedy tokens must agree wherever JAX's top-2 margin exceeds twice it
    (each of the two logits may move by the tolerance)."""
    tol = 0.03
    cfg, jm, jp, tm, tp = _pair("qwen2-1.5b", dtype="bfloat16")
    assert tp["trunk"]["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    jb, tb = _batches(cfg, S)
    jl = np.asarray(jm.forward(jp, jb)[0], np.float32)
    tl = tm.forward(tp, tb)[0].numpy()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=tol)
    top2 = np.sort(jl, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    assert clear.mean() > 0.25
    assert (tl.argmax(-1) == jl.argmax(-1))[clear].all()
    jpb, tpb = {"tokens": jb["tokens"][:, :P]}, {"tokens": tb["tokens"][:, :P]}
    _, jc = jm.prefill(jp, jpb)
    _, tc = tm.prefill(tp, tpb)
    jc, tc = jm.cache_from_prefill(jc, 64), tm.cache_from_prefill(tc, 64)
    assert tc[0]["0"][0].dtype == torch.bfloat16
    for t in range(P, S):            # 8 steps
        jd, jc = _jax_side("qwen2-1.5b", "bfloat16")[3](
            jp, jc, jb["tokens"][:, t], jnp.int32(t))
        td, tc = tm.decode_step(tp, tc, tb["tokens"][:, t], t)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd, np.float32),
                                   rtol=0, atol=tol)


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_configs_equal_jax_field_for_field(arch):
    t, j = TC.get_config(arch), JC.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.smoke()) == dataclasses.asdict(j.smoke())
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert TC.ARCHS == JC.ARCHS and TC.SHAPES == JC.SHAPES
    assert list(TC.all_cells()) == list(JC.all_cells())


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_every_config_builds_on_ported_kinds(arch):
    """Each config builds the model class JAX builds for it, and every
    layer kind of its pattern (or the encoder-decoder) is ported."""
    from repro_torch.models.model import EncDecModel, Model

    for cfg in (TC.get_config(arch), TC.get_config(arch).smoke()):
        model = build_model(cfg)
        assert type(model).__name__ == type(jax_build(cfg)).__name__
        if cfg.family == "encdec":
            assert isinstance(model, EncDecModel)
            assert cfg.enc_layers and cfg.n_layers
            continue
        assert isinstance(model, Model)
        kinds = {k for pat, _ in TT._pattern(cfg) for k in pat}
        assert kinds <= set(TT.PORTED_KINDS)
    assert set(TT.PORTED_KINDS) == {"global", "local", "moe", "ssm", "rec"}


@pytest.mark.parametrize("arch", DENSE)
def test_init_draws_jax_shapes_and_distributions(arch):
    cfg = TC.get_config(arch).smoke()
    tp = build_model(cfg).init(torch.Generator().manual_seed(0))
    jp = jax_build(JC.get_config(arch).smoke()).init(jax.random.PRNGKey(0))
    conv = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    got = {k: (tuple(v.shape), v.dtype) for k, v in tp.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in conv.named_parameters()}
    assert got == want
    assert sum(v.numel() for v in tp.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert not any(v.requires_grad for v in tp.parameters())
    tok = tp["embed"]["tok"]
    assert abs(float(tok.std()) - 0.02) < 0.002
    wq = tp["trunk"]["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    again = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tp.parameters(),
                                                 again.parameters()))


def test_init_defaults_to_the_card():
    model = build_model(TC.get_config("qwen2-1.5b").smoke())
    if torch.cuda.is_available():
        assert model.init()["embed"]["tok"].is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    assert model.init_cache(1, 8, device="cpu")[0]["0"][0].shape == (
        2, 1, 8, 2, 16)
