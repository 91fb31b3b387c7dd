"""The port's MoE, Mamba-2 SSD, RG-LRU hybrid and Whisper encoder-decoder
(repro_torch.models.{moe,ssm,rglru,encdec} and the trunk kinds "moe",
"ssm", "rec") against the JAX package's on the CPU, on the smoke configs
of granite-moe-3b-a800m, olmoe-1b-7b (qk_norm), mamba2-780m (chunk 16),
recurrentgemma-9b (rec, rec, local with window 16, MQA) and whisper-base,
with JAX's ``init`` params carried across by ``convert`` and the same
numpy-seeded tokens and frames. Held at rtol = atol = 1e-4 (f32; the two
differ only in the order of float sums), decode against the full forward
at 5e-3 as tests/test_models_smoke.py holds it: ``forward`` logits,
``loss_and_metrics`` with the MoE aux loss, ``prefill`` caches (states and
conv tails included), ``cache_from_prefill`` above and below the prompt
(the local layers' ring), 16 teacher-forced ``decode_step``s, and
whisper's ``encode`` / ``decode_fwd`` / ``decode_step``. MoE routing is
held EQUAL, not close: expert choices, the dispatch order, weights,
``keep`` and ``slot``, on tied router scores and on a group past the
drop-free capacity whose tokens are dropped. Also ``apply_ssm``'s error on
a length its chunk does not divide, and the port's own init against
JAX's shapes and distributions."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import encdec as jed
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build
from repro_torch.convert import (encdec_params_from_numpy,
                                 lm_params_from_numpy)
from repro_torch.models import encdec as ted
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model

DECODERS = ("granite-moe-3b-a800m", "olmoe-1b-7b", "mamba2-780m",
            "recurrentgemma-9b")
MOE = ("granite-moe-3b-a800m", "olmoe-1b-7b")
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=5e-3, atol=5e-3)
# a prompt of 16 and 16 decode steps: mamba2's smoke chunk (16) divides
# both the prompt and the full 32, and the decode runs past the window
B, S, P = 2, 32, 16


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """(config, model, params, jitted decode_step) of the JAX package."""
    jcfg = JC.get_config(arch).smoke()
    jm = jax_build(jcfg)
    return jcfg, jm, jm.init(jax.random.PRNGKey(1)), jax.jit(jm.decode_step)


def _pair(arch):
    jcfg, jm, jp, _ = _jax_side(arch)
    tcfg = TC.get_config(arch).smoke()
    tree = jax.tree.map(np.asarray, jp)
    if tcfg.family == "encdec":
        tp = encdec_params_from_numpy(tcfg, tree, device="cpu")
    else:
        tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jm, jp, build_model(tcfg), tp


def _tokens(cfg, n, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)).astype(
        np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


def _close(t, j, what, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               err_msg=what, **tol)


def _leaves(tree):
    """The port's caches in jax.tree.leaves order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same_leaves(t, j, what):
    tl, jl = _leaves(t), jax.tree.leaves(j)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl], what
    for i, (a, b) in enumerate(zip(tl, jl)):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        _close(a, b, f"{what} leaf {i}")


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_loss_and_aux_match_jax(arch):
    cfg, jm, jp, tm, tp = _pair(arch)
    jt, tt = _tokens(cfg, S)
    jl, _, jaux = jm.forward(jp, {"tokens": jt})
    tl, caches, taux = tm.forward(tp, {"tokens": tt})
    assert caches is None and tl.shape == (B, S, cfg.vocab)
    _close(tl, jl, f"{arch} forward logits")
    _close(taux, jaux, f"{arch} aux")
    assert (float(taux) > 0) == (arch in MOE)
    jloss, jmet = jm.loss_and_metrics(jp, {"tokens": jt})
    tloss, tmet = tm.loss_and_metrics(tp, {"tokens": tt})
    _close(tloss, jloss, f"{arch} loss")
    _close(tmet["aux"], jmet["aux"], f"{arch} loss aux")


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_caches_match_jax(arch):
    cfg, jm, jp, tm, tp = _pair(arch)
    jt, tt = _tokens(cfg, P)
    jlast, jc = jm.prefill(jp, {"tokens": jt})
    tlast, tc = tm.prefill(tp, {"tokens": tt})
    _close(tlast, jlast, f"{arch} prefill logits")
    _same_leaves(tc, jc, f"{arch} prefill cache")


@pytest.mark.parametrize("cache_len", [64, 12], ids=["above", "below"])
@pytest.mark.parametrize("arch", DECODERS)
def test_cache_from_prefill_and_decode_match_jax(arch, cache_len):
    """cache_len 64 pads the attention caches (recurrentgemma's local
    layers keep a ring of their window, 16, which the 16 steps wrap); 12
    is below the prompt, so a local layer keeps a ring of 12 and a global
    layer is clamped as JAX's dynamic_update_slice clamps. SSM and RG-LRU
    states pass through and are updated in place."""
    cfg, jm, jp, tm, tp = _pair(arch)
    jt, tt = _tokens(cfg, S)
    jfull, _, _ = jm.forward(jp, {"tokens": jt})
    _, jc = jm.prefill(jp, {"tokens": jt[:, :P]})
    _, tc = tm.prefill(tp, {"tokens": tt[:, :P]})
    jc = jm.cache_from_prefill(jc, cache_len)
    tc = tm.cache_from_prefill(tc, cache_len)
    _same_leaves(tc, jc, f"{arch} decode cache")
    step = _jax_side(arch)[3]
    for t in range(P, S):
        jl, jc = step(jp, jc, jt[:, t], jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, tt[:, t], t)
        _close(tl, jl, f"{arch} decode logits at {t}")
    _same_leaves(tc, jc, f"{arch} cache after decode")
    if cache_len > S:
        _close(tl, jfull[:, -1], f"{arch} decode against forward",
               tol=DECODE_TOL)


def test_whisper_encode_decode_match_jax():
    """whisper-base's smoke config: ``encode`` of 24 frames, ``decode_fwd``
    with its self and cross caches, ``prefill``, the loss, and 16
    ``decode_step``s on the prefill's self caches padded to 32 (as
    tests/test_models_smoke.py pads them) against the full decoder."""
    cfg, jm, jp, tm, tp = _pair("whisper-base")
    jt, tt = _tokens(cfg, S)
    frames = np.random.default_rng(1).standard_normal(
        (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    jenc = jed.encode(cfg, jp, jf)
    tenc = ted.encode(cfg, tp, tf)
    _close(tenc, jenc, "encode")
    jfull, jc = jed.decode_fwd(cfg, jp, jt, jenc, want_cache=True)
    tfull, tc = ted.decode_fwd(cfg, tp, tt, tenc, want_cache=True)
    _close(tfull, jfull, "decode_fwd logits")
    _same_leaves(tc, jc, "decode_fwd caches")
    assert ted.decode_fwd(cfg, tp, tt, tenc, want_cache=False)[1] is None
    jloss, _ = jm.loss_and_metrics(jp, {"tokens": jt, "frames": jf})
    tloss, tmet = tm.loss_and_metrics(tp, {"tokens": tt, "frames": tf})
    _close(tloss, jloss, "loss")
    assert float(tmet["aux"]) == 0.0
    jlast, jc = jm.prefill(jp, {"tokens": jt[:, :P], "frames": jf})
    tlast, tc = tm.prefill(tp, {"tokens": tt[:, :P], "frames": tf})
    _close(tlast, jlast, "prefill logits")
    _same_leaves(tc, jc, "prefill caches")
    (sk, sv), cross = jc
    pad = [(0, 0), (0, 0), (0, S - P), (0, 0), (0, 0)]
    jc = ((jnp.pad(sk, pad), jnp.pad(sv, pad)), cross)
    (sk, sv), tcross = tc
    zk = torch.zeros(sk.shape[:2] + (S,) + sk.shape[3:])
    zv = torch.zeros_like(zk)
    zk[:, :, :P], zv[:, :, :P] = sk, sv
    tc = ((zk, zv), tcross)
    assert tm.init_cache(B, S, device="cpu")[0][0].shape == zk.shape
    step = _jax_side("whisper-base")[3]
    for t in range(P, S):
        jl, jc = step(jp, jc, jt[:, t], jnp.int32(t))
        tl, tc = tm.decode_step(tp, tc, tt[:, t], t)
        _close(tl, jl, f"decode logits at {t}")
        _close(tl, jfull[:, t], f"decode against decode_fwd at {t}",
               tol=DECODE_TOL)
    assert tc[1] is tcross and tc[0][0] is zk       # cross fixed, self in place
    _same_leaves(tc, jc, "caches after decode")


def _jax_routing(cfg, router, x, cap):
    """JAX's _dispatch_group on every group: (se, st, sw, keep, slot, top_e)."""
    def one(xg):
        _, st, sw, keep, slot, _ = jmoe._dispatch_group(cfg, xg, router, cap)
        probs = jax.nn.softmax(xg.astype(jnp.float32) @ router, axis=-1)
        top_e = jax.lax.top_k(probs, cfg.top_k)[1]
        se = jnp.sort(top_e.reshape(-1), stable=True)
        return se, st, sw, keep, slot, top_e
    return [np.asarray(a) for a in jax.vmap(one)(x)]


def _routing_case(case):
    """(config, router, x) of one routing case at olmoe's smoke width."""
    cfg = JC.get_config("olmoe-1b-7b").smoke()
    rng = np.random.default_rng(5)
    b, s = 2, 24
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(
        np.float32) * cfg.d_model ** -0.5
    if case == "zero_router":        # every score ties: experts 0 .. k-1
        router[:] = 0
    elif case == "duplicate_columns":   # experts 4-7 tie with 0-3
        router[:, 4:] = router[:, :4]
    elif case == "drops":            # one group past the drop-free capacity,
        b, s = 1, 2056               # expert 0 favoured, so it overflows
        cfg = dataclasses.replace(cfg, top_k=2)
        router[0, 0] = 4.0
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if case == "drops":
        x[..., 0] = np.abs(x[..., 0])
    return cfg, router, x


@pytest.mark.parametrize("case", ["random", "zero_router",
                                  "duplicate_columns", "drops"])
def test_moe_routing_equals_jax(case):
    cfg, router, x = _routing_case(case)
    tcfg = dataclasses.replace(TC.get_config("olmoe-1b-7b").smoke(),
                               top_k=cfg.top_k)
    cap = tmoe.capacity(tcfg, x.shape[1])
    jcap = (x.shape[1] * cfg.top_k if x.shape[1] * cfg.top_k <= 4096
            else int(max(1, round(x.shape[1] * cfg.top_k / cfg.n_experts
                                  * 1.25))))
    assert cap == jcap
    want = _jax_routing(cfg, jnp.asarray(router), jnp.asarray(x), cap)
    got = tmoe.route(tcfg, torch.from_numpy(router), torch.from_numpy(x), cap)
    for name, w in zip(("se", "st", "sw", "keep", "slot", "top_e"), want):
        g = got[name].numpy()
        if name == "sw":
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name}")
    if case == "zero_router":
        assert (got["top_e"] == torch.arange(cfg.top_k)).all()
    if case == "duplicate_columns":
        top = got["top_e"][..., :2].sort(-1).values
        assert ((top[..., 1] - top[..., 0]) == 4).all()  # tied pairs, both
    dropped = int((~got["keep"]).sum())
    assert (dropped > 0) == (case == "drops")
    # the layer around the routing: JAX's padded buffer, the port's rows
    p = {"router": router}
    rng = np.random.default_rng(6)
    for name, shape in (("wi", (cfg.n_experts, cfg.d_model, cfg.expert_ff)),
                        ("wg", (cfg.n_experts, cfg.d_model, cfg.expert_ff)),
                        ("wo", (cfg.n_experts, cfg.expert_ff, cfg.d_model))):
        p[name] = (rng.standard_normal(shape) * shape[1] ** -0.5).astype(
            np.float32)
    jy, jaux = jmoe.apply_moe(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    ty, taux = tmoe.apply_moe(tcfg, {k: torch.from_numpy(v)
                                     for k, v in p.items()},
                              torch.from_numpy(x))
    _close(ty, jy, f"{case}: apply_moe")
    _close(taux, jaux, f"{case}: aux")


def test_apply_ssm_raises_where_jax_asserts():
    """24 tokens in chunks of 16: JAX's ``assert s % q == 0`` fires, and the
    port raises the same AssertionError (a check, not an assert)."""
    cfg, _, jp, _, tp = _pair("mamba2-780m")
    x = np.random.default_rng(2).standard_normal((1, 24, cfg.d_model)).astype(
        np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["trunk"]["stacks"][0]["0"]["ssm"])
    with pytest.raises(AssertionError):
        jssm.apply_ssm(cfg, jl, jnp.asarray(x))
    with pytest.raises(AssertionError, match="24, 16"):
        tssm.apply_ssm(cfg, tp["trunk"]["layers"][0]["ssm"],
                       torch.from_numpy(x))
    y, state, tail = tssm.apply_ssm(cfg, tp["trunk"]["layers"][0]["ssm"],
                                    torch.from_numpy(x[:, :16]))
    assert y.shape == (1, 16, cfg.d_model) and tail.shape == (
        1, cfg.ssm_conv - 1, cfg.ssm_expand * cfg.d_model)


@pytest.mark.parametrize("arch", DECODERS + ("whisper-base",))
def test_init_draws_jax_shapes_and_distributions(arch):
    cfg = TC.get_config(arch).smoke()
    tp = build_model(cfg).init(torch.Generator().manual_seed(0))
    _, _, _, _, conv = _pair(arch)
    got = {k: (tuple(v.shape), v.dtype) for k, v in tp.named_parameters()}
    want = {k: (tuple(v.shape), v.dtype) for k, v in conv.named_parameters()}
    assert got == want
    assert not any(v.requires_grad for v in tp.parameters())
    params = dict(tp.named_parameters())
    for name, v in params.items():
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("conv_b", "dt_bias", "b_a", "b_i"):
            assert not v.any(), name
        elif leaf == "dskip":
            assert (v == 1).all(), name
        elif leaf == "lam":
            assert (v == 0.7).all(), name
        elif leaf == "a_log":
            want_a = torch.log(torch.linspace(1.0, 16.0, v.shape[0]))
            assert torch.equal(v, want_a), name
        elif leaf == "conv_w":
            assert abs(float(v.std()) - 0.5) < 0.1, name
        elif leaf in ("router", "wi", "wg", "w_a", "in_x"):
            fan_in = v.shape[-2]
            assert abs(float(v.std()) - fan_in ** -0.5) < 0.15 * fan_in ** -0.5, name
    again = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tp.parameters(),
                                                 again.parameters()))
