"""The port's LM training path (repro_torch.optim, launch.steps,
runtime.train_loop, launch.train, the trainable models) against the JAX
package's on the CPU, at smoke shapes, on the same numpy-seeded inputs and
on JAX's params through ``convert``. Every tree is compared leaf for leaf in
JAX's layout (``convert.lm_params_to_numpy`` restacks the port's layers).

Tolerances: the optimizer's f32 arithmetic at rtol 1e-6 (and one
rounding of the operands, where an update cancels a param); losses and every
gradient leaf at rtol = atol = 1e-4 relative to the leaf's max |g| (f32 on
both sides, differing only in the order of float sums); a train step's
params at 1e-5 (the first Adam step moves each element by ~lr, so this is
1% of the step); the port against itself (remat, crash and resume, the
bf16 round trip) bit for bit."""
import dataclasses
import filecmp
import functools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data.pipeline import GraphPathData as JGraphData
from repro.launch import steps as jsteps
from repro.launch import train as jlaunch
from repro.models.model import build_model as jax_build
from repro.models.model import cross_entropy as jax_xent
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jsched
from repro.runtime.train_loop import TrainLoopConfig as JLoopConfig
from repro.runtime.train_loop import train as jtrain
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint import checkpointer as ckpt_mod
from repro_torch.convert import (adamw_state_from_numpy,
                                 adamw_state_to_numpy, from_jax_tree,
                                 lm_params_from_numpy, lm_params_to_numpy)
from repro_torch.data.pipeline import GraphPathData, SyntheticLMData
from repro_torch.launch import steps
from repro_torch.launch import train as tlaunch
from repro_torch.models.attention import _bmm_acc, _bmm_f32
from repro_torch.models.model import build_model, cross_entropy
from repro_torch.models.rglru import linear_scan
from repro_torch.optim import adamw, grad_compress, schedule
from repro_torch.runtime.train_loop import (SimulatedFailure, TrainLoopConfig,
                                            restore_train_state, train,
                                            train_tree)

ROOT = Path(__file__).resolve().parents[1]
TRAINABLE = ("olmo-1b", "qwen2-1.5b", "granite-moe-3b-a800m", "mamba2-780m",
             "recurrentgemma-9b")
B, S = 2, 32
# p - lr * delta cancels where the two are close; an element there can
# differ by one f32 rounding of its operands (~1e-2: ulp 9.3e-10) and so
# miss a relative tolerance
OPERAND_ULP = 1e-9


def _pair(arch, dtype="float32", seed=1):
    """(JAX model, JAX params, port model, port params on JAX's values)."""
    jcfg = dataclasses.replace(JC.get_config(arch).smoke(), dtype=dtype)
    tcfg = dataclasses.replace(TC.get_config(arch).smoke(), dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return jm, jp, build_model(tcfg), tp


def _tokens(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _same_tree(got, want, what, **tol):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, f"{what} leaf {i}"
        if tol:
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32),
                                       err_msg=f"{what} leaf {i}", **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def _close_per_leaf_max(got, want, what, tol=1e-4):
    """|got - want| <= tol * max |want| on every leaf."""
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want), strict=True)):
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a.astype(np.float32) - b).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol} * {scale}"


def _bits(t):
    return t.detach().contiguous().view(torch.uint8)


def _same_step(got, want, mu, lr, what, quantum=None):
    """Params after one train step within 1e-5 of JAX's, except where the
    first Adam step's direction is undetermined at the gradients'
    tolerance: it moves an element by ~lr * sign(g), so where JAX's first
    moment ``mu`` (0.1 g) is within 1e-4 of its leaf's max of 0 (or, with
    int8 compression, within one quantum: a code of 0 or +-1 that a
    rounding can move) the element may differ by up to 2.2 lr."""
    for i, (a, b, m) in enumerate(zip(_leaves(got), _leaves(want),
                                      _leaves(mu), strict=True)):
        a, b = a.astype(np.float32), b.astype(np.float32)
        edge = np.abs(m).max() * (1.01 / 127 if quantum else 1e-4)
        tol = np.where(np.abs(m) <= edge, 2.2 * lr, 1e-5)
        bad = np.abs(a - b) > tol
        assert not bad.any(), (f"{what} leaf {i}: {int(bad.sum())} elements,"
                               f" max {float(np.abs(a - b)[bad].max())}")


def _grads(tm, tp, toks, remat):
    leaves = dict(tp.named_parameters())
    for p in leaves.values():
        p.requires_grad_(True)
    loss, _ = tm.loss_and_metrics(tp, {"tokens": torch.from_numpy(toks)},
                                  remat=remat)
    g = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, g))


# ----------------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------------
def _random_grads(jp, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("gscale", [1e-3, 1.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax_over_three_steps(gscale):
    jm, jp, tm, tp = _pair("qwen2-1.5b")
    cfg = tm.cfg
    js, ts = jadamw.init(jp), adamw.init(tp)
    for k in range(3):
        g = _random_grads(jp, gscale, seed=k)
        gnorm = np.sqrt(sum(float(np.square(x).sum())
                            for x in jax.tree.leaves(g)))
        assert (gnorm > 1.0) == (gscale == 1.0)   # the clip engages or not
        jp, js = jadamw.update(jp, jax.tree.map(jnp.asarray, g), js, lr=1e-3)
        tg = {n: torch.from_numpy(np.asarray(x))
              for n, x in from_jax_tree(cfg, tp, g).items()}
        tp, ts = adamw.update(tp, tg, ts, lr=1e-3)
        _same_tree(lm_params_to_numpy(cfg, tp), jp, f"params {k}",
                   rtol=1e-6, atol=OPERAND_ULP)
        _same_tree(adamw_state_to_numpy(cfg, tp, ts), js, f"state {k}",
                   rtol=1e-6, atol=OPERAND_ULP)


def test_weight_decay_follows_jax_s_stacked_rank():
    """Zero gradients leave only the decay: a trunk norm scale and a q bias,
    1-D in the port but [G, d] in JAX, are decayed; final_norm is not."""
    jm, jp, tm, tp = _pair("qwen2-1.5b")
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    zeros = {n: torch.zeros_like(p) for n, p in tp.named_parameters()}
    tp, _ = adamw.update(tp, zeros, adamw.init(tp), lr=0.5,
                         weight_decay=0.1)
    now = dict(tp.named_parameters())
    for name in ("trunk.layers.0.norm1.scale", "trunk.layers.1.attn.bq"):
        assert now[name].ndim == 1
        torch.testing.assert_close(now[name], before[name] * (1 - 0.05),
                                   rtol=1e-6, atol=1e-7)
    assert torch.equal(now["trunk.final_norm.scale"],
                       before["trunk.final_norm.scale"])
    jz = jax.tree.map(jnp.zeros_like, jp)
    jp2, _ = jadamw.update(jp, jz, jadamw.init(jp), lr=0.5, weight_decay=0.1)
    _same_tree(lm_params_to_numpy(tm.cfg, tp), jp2, "decayed params",
               rtol=1e-6, atol=OPERAND_ULP)


def test_grad_compress_gives_jax_s_codes_and_residuals():
    ties = np.array([2.5, -2.5, 3.5, 127.0, 0.5, 1.5, -0.5], np.float32)
    q, s = grad_compress._quant(torch.from_numpy(ties))
    jq, jsc = jgc._quant(jnp.asarray(ties))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and float(s) == float(jsc)
    rng = np.random.default_rng(0)
    shapes = {"a": (64,), "b": (8, 16)}
    tef = grad_compress.init({k: torch.zeros(v) for k, v in shapes.items()})
    jef = jgc.init({k: jnp.zeros(v) for k, v in shapes.items()})
    for _ in range(3):
        g = {k: (rng.normal(size=v) * 0.1).astype(np.float32)
             for k, v in shapes.items()}
        tg, tef = grad_compress.compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()}, tef)
        jg, jef = jgc.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        for k in shapes:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(tef.residual[k].numpy(),
                                          np.asarray(jef.residual[k]))


@pytest.mark.parametrize("step", [0, 3, 10, 11, 55, 100, 130])
def test_schedules_equal_jax(step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    got = schedule.warmup_cosine(step, **kw)
    assert got.dtype == torch.float32
    assert float(got) == float(jsched.warmup_cosine(step, **kw))
    assert float(schedule.constant(step, **kw)) == float(
        jsched.constant(step, **kw))


# ----------------------------------------------------------------------------
# loss and gradients
# ----------------------------------------------------------------------------
@pytest.mark.parametrize("arch", TRAINABLE)
def test_loss_and_every_gradient_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jm.loss_and_metrics(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jp)
    loss, g = _grads(tm, tp, toks, remat=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-4)
    _close_per_leaf_max(lm_params_to_numpy(tm.cfg, tp, g), jg,
                        f"{arch} grads")
    # remat recomputes each group's forward: the same numbers, bit for bit
    loss0, g0 = _grads(tm, tp, toks, remat=False)
    assert torch.equal(loss0, loss)
    assert all(torch.equal(g0[n], g[n]) for n in g)


def test_cross_entropy_mask_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (2, 5)).astype(np.int32)
    masks = {"none": None, "random": rng.integers(0, 2, (2, 5)),
             "ones": np.ones((2, 5)), "zeros": np.zeros((2, 5))}
    for what, m in masks.items():
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt),
                            None if m is None else torch.from_numpy(m))
        want = jax_xent(jnp.asarray(logits), jnp.asarray(tgt),
                        None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=what)
    assert float(got) == 0.0          # an all-zero mask


def test_bf16_products_have_a_gradient():
    """``bmm``'s ``out_dtype`` overload has no gradient; ``_bmm_f32`` routes
    a product that needs one through its own: the forward bit for bit the
    serving product, the gradients those of the f32 product within bf16
    rounding."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((3, 16, 5)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    y = _bmm_f32(a, b)
    assert y.dtype == torch.float32 and torch.equal(y, _bmm_acc(a, b))
    dy = torch.from_numpy(rng.standard_normal((3, 4, 5)).astype(np.float32))
    da, db = torch.autograd.grad(y, (a, b), dy)
    assert da.dtype == db.dtype == torch.bfloat16
    a32, b32 = a.detach().float(), b.detach().float()
    torch.testing.assert_close(da.float(), dy @ b32.transpose(1, 2),
                               rtol=0.02, atol=0.05)
    torch.testing.assert_close(db.float(), a32.transpose(1, 2) @ dy,
                               rtol=0.02, atol=0.05)


def test_linear_scan_builds_new_tensors_with_the_recurrence_s_sums():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 3)).astype(
        np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((2, 13, 3)).astype(np.float32))
    h = linear_scan(a, b)
    want, hp = [], torch.zeros(2, 3)
    for t in range(13):
        hp = a[:, t] * hp + b[:, t]
        want.append(hp)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad(h.sum(), a)   # no in-place version errors
    assert torch.isfinite(g).all()


# ----------------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------------
def test_train_step_matches_jax():
    jm, jp, tm, tp = _pair("qwen2-1.5b")
    toks = _tokens(tm.cfg, b=4)
    jst = jax.jit(jsteps.make_train_step(jm, lr=1e-3, remat=True))
    jp2, js2, jmet = jst(jp, jsteps.init_opt_state(jp),
                         {"tokens": jnp.asarray(toks)})
    tst = steps.make_train_step(tm, lr=1e-3, remat=True)
    tp2, ts2, tmet = tst(tp, steps.init_opt_state(tp),
                         {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    _same_step(lm_params_to_numpy(tm.cfg, tp2), jp2, js2.mu, 1e-3, "params")
    _close_per_leaf_max(adamw_state_to_numpy(tm.cfg, tp2, ts2).mu, js2.mu,
                        "first moments")
    assert int(ts2.step) == int(js2.step) == 1


def test_microbatches_equal_full_batch():
    """The port's own accumulation, as tests/test_optim.py holds JAX's."""
    _, _, tm, tp = _pair("olmo-1b", seed=0)
    toks = torch.from_numpy(_tokens(tm.cfg, seed=3, b=4))
    tp1 = lm_params_from_numpy(tm.cfg, lm_params_to_numpy(tm.cfg, tp),
                               device="cpu")
    outs = []
    for mb, params in ((1, tp), (2, tp1)):
        step = steps.make_train_step(tm, lr=1e-2, microbatches=mb,
                                     remat=False)
        p, _, m = step(params, steps.init_opt_state(params),
                       {"tokens": toks})
        outs.append((lm_params_to_numpy(tm.cfg, p), float(m["loss"])))
    _same_tree(outs[1][0], outs[0][0], "microbatched params", rtol=0,
               atol=5e-3)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5)


def test_compressed_train_step_matches_jax():
    jm, jp, tm, tp = _pair("olmo-1b")
    toks = _tokens(tm.cfg)
    jst = jax.jit(jsteps.make_train_step(jm, lr=1e-3, compress=True,
                                         remat=False))
    jp2, jo, _ = jst(jp, jsteps.init_opt_state(jp, compress=True),
                     {"tokens": jnp.asarray(toks)})
    tst = steps.make_train_step(tm, lr=1e-3, compress=True, remat=False)
    tp2, to, _ = tst(tp, steps.init_opt_state(tp, compress=True),
                     {"tokens": torch.from_numpy(toks)})
    assert sorted(to) == ["adam", "ef"]
    _same_step(lm_params_to_numpy(tm.cfg, tp2), jp2, jo["adam"].mu, 1e-3,
               "params", quantum=True)
    # a residual is what the int8 code dropped (at most half a quantum):
    # a code that a rounding moved moves it by one quantum
    for r, jr in zip(_leaves(lm_params_to_numpy(tm.cfg, tp2,
                                                to["ef"].residual)),
                     _leaves(jo["ef"].residual), strict=True):
        assert np.abs(r - jr).max() <= 2.02 * np.abs(jr).max()


def _host_mesh():
    """The (1, 1) mesh of a one-process gloo group (the caller destroys
    the group)."""
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(device_type="cpu")


def test_the_one_device_step_refuses_gradient_shardings():
    """``grad_specs`` pins every gradient to its parameter's placement: on
    a (1, 1) mesh, DTensor params and batch, a microbatched step equals
    the plain step bit for bit, and each moment keeps its parameter's
    placement."""
    import torch.distributed as dist

    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.train_loop import (distribute_params,
                                                train_shardings)

    tm = build_model(TC.get_config("olmo-1b").smoke())
    tp, tq = (tm.init(torch.Generator("cpu").manual_seed(1))
              for _ in range(2))
    toks = torch.from_numpy(_tokens(tm.cfg, b=4))
    want_p, want_s, want_m = steps.make_train_step(tm, microbatches=2)(
        tp, steps.init_opt_state(tp), {"tokens": toks})
    mesh = _host_mesh()
    try:
        shardings = train_shardings(tm.cfg, tq, mesh)[0]
        distribute_params(tq, shardings)
        batch = {"tokens": sh.distribute(toks, sh.to_named(
            sh.batch_spec(mesh, "tokens", tuple(toks.shape)), mesh))}
        sh.set_activation_mesh(mesh)
        try:
            got_p, got_s, got_m = steps.make_train_step(
                tm, microbatches=2, grad_specs=shardings)(
                    tq, steps.init_opt_state(tq), batch)
        finally:
            sh.set_activation_mesh(None)
        assert torch.equal(got_m["loss"].full_tensor(), want_m["loss"])
        for (n, a), b in zip(got_p.named_parameters(), want_p.parameters(),
                             strict=True):
            assert a.placements == shardings[n].placements
            assert torch.equal(_bits(a.to_local()), _bits(b)), n
            assert got_s.mu[n].placements == a.placements
            assert torch.equal(got_s.nu[n].to_local(), want_s.nu[n]), n
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------------------
# train loop and checkpoints
# ----------------------------------------------------------------------------
def _loop(tmp, name, steps_, **kw):
    return TrainLoopConfig(total_steps=steps_, checkpoint_every=2,
                           log_every=1, checkpoint_dir=str(tmp / name),
                           lr=1e-3, **kw)


def test_train_loss_decreases(tmp_path):
    _, _, tm, _ = _pair("olmo-1b")
    params = tm.init(torch.Generator("cpu").manual_seed(0))
    tl = TrainLoopConfig(total_steps=30, checkpoint_every=100, log_every=1,
                         checkpoint_dir=str(tmp_path), lr=1e-3)
    _, _, hist = train(tm, SyntheticLMData(64, seed=0), batch_size=4,
                       seq_len=32, cfg=tl, params=params,
                       log=lambda *_: None)
    losses = [l for _, l, _ in hist]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_train_on_graph_path_task(tmp_path):
    _, _, tm, _ = _pair("qwen2-1.5b")
    params = tm.init(torch.Generator("cpu").manual_seed(0))
    tl = TrainLoopConfig(total_steps=8, checkpoint_every=100, log_every=1,
                         checkpoint_dir=str(tmp_path), lr=1e-3)
    _, _, hist = train(tm, GraphPathData(n_vertices=8, seed=0, device="cpu"),
                       batch_size=2, seq_len=96, cfg=tl, params=params,
                       log=lambda *_: None)
    assert len(hist) == 8 and np.isfinite([l for _, l, _ in hist]).all()


def _crashed_writers_finish(timeout_s=60.0):
    """An in-process crash leaves the step-2 checkpoint's writer thread
    running (a kill -9 would not); wait until it has published, so that the
    resumed run starts from step 2 and not, by a race, from scratch."""
    t0 = time.monotonic()
    while ckpt_mod._live_tmp and time.monotonic() - t0 < timeout_s:
        time.sleep(0.01)
    assert not ckpt_mod._live_tmp


def _port_run(tm, tmp, name, steps_, **kw):
    params = tm.init(torch.Generator("cpu").manual_seed(0))
    data = GraphPathData(n_vertices=8, seed=0, device="cpu")
    return train(tm, data, batch_size=2, seq_len=96,
                 cfg=_loop(tmp, name, steps_, **kw), params=params,
                 log=lambda *_: None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crash_and_resume_equals_an_uninterrupted_run(tmp_path, dtype):
    tm = build_model(dataclasses.replace(TC.get_config("qwen2-1.5b").smoke(),
                                         dtype=dtype))
    p0, s0, h0 = _port_run(tm, tmp_path, "whole", 6)
    with pytest.raises(SimulatedFailure):
        _port_run(tm, tmp_path, "crash", 6, simulate_failure_at=3)
    _crashed_writers_finish()
    p1, s1, h1 = _port_run(tm, tmp_path, "crash", 6)
    assert [s for s, _, _ in h1] == [3, 4, 5, 6]     # resumed from step 2
    assert [l for _, l, _ in h1] == [l for _, l, _ in h0[2:]]
    for a, b in zip(p0.parameters(), p1.parameters(), strict=True):
        assert torch.equal(_bits(a), _bits(b))
    assert int(s0.step) == int(s1.step) == 6
    assert all(torch.equal(s0.mu[n], s1.mu[n]) and torch.equal(s0.nu[n],
                                                               s1.nu[n])
               for n in s0.mu)


def test_bf16_checkpoint_is_jax_s_bytes_and_restores_bit_for_bit(tmp_path):
    """The port writes a bf16 train state as JAX writes it (each leaf file
    byte for byte, the manifest apart from its time) and restores every
    leaf bit for bit; JAX's own restore of it raises (ROADMAP.md C3)."""
    tm = build_model(dataclasses.replace(TC.get_config("qwen2-1.5b").smoke(),
                                         dtype="bfloat16"))
    params, state, _ = _port_run(tm, tmp_path, "port", 2)
    as_jax = functools.partial(jax.tree.map, lambda a: a.view(jnp.bfloat16)
                               if a.dtype.kind == "V" else a)
    JCheckpointer(str(tmp_path / "jax")).save(
        2, (as_jax(lm_params_to_numpy(tm.cfg, params)),
            jadamw.AdamWState(*adamw_state_to_numpy(tm.cfg, params, state))),
        blocking=True)
    pdir, jdir = tmp_path / "port" / "step_000000002", \
        tmp_path / "jax" / "step_000000002"
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names
    leaves = [n for n in names if n.endswith(".npy")]
    assert filecmp.cmpfiles(pdir, jdir, leaves, shallow=False)[0] == leaves
    pm, jman = (json.loads((d / "manifest.json").read_text())
                for d in (pdir, jdir))
    del pm["time"], jman["time"]
    assert pm == jman and "bfloat16" in pm["dtypes"]

    fresh = tm.init(torch.Generator("cpu").manual_seed(9))
    opt = steps.init_opt_state(fresh)
    opt, man = restore_train_state(Checkpointer(str(tmp_path / "port")),
                                   tm.cfg, fresh, opt)
    assert man["step"] == 2 and int(opt.step) == 2
    assert {p.dtype for p in fresh.parameters()} == {torch.bfloat16,
                                                     torch.float32}
    for a, b in zip(params.parameters(), fresh.parameters(), strict=True):
        assert torch.equal(_bits(a), _bits(b))
    assert all(torch.equal(state.mu[n], opt.mu[n]) for n in opt.mu)

    jm = jax_build(dataclasses.replace(JC.get_config("qwen2-1.5b").smoke(),
                                       dtype="bfloat16"))
    jp = jm.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="No cast function"):
        JCheckpointer(str(tmp_path / "port")).restore(
            (jp, jsteps.init_opt_state(jp)))


def test_each_package_resumes_from_the_other_s_directory(tmp_path):
    """f32: JAX trains 2 steps into a directory the port resumes from, and
    the port 2 steps into one JAX resumes from; each restore equals what the
    writer held, leaf for leaf, and each resumed third step equals the
    writer's own third step within the train-step tolerance."""
    jm, jp, tm, tp = _pair("qwen2-1.5b", seed=0)
    cfg = tm.cfg

    def jax_run(name, n, params, log=lambda *_: None):
        """JAX's loop donates the params it is given: pass it a copy."""
        tl = JLoopConfig(total_steps=n, checkpoint_every=2, log_every=1,
                         checkpoint_dir=str(tmp_path / name), lr=1e-3)
        return jtrain(jm, JGraphData(n_vertices=8, seed=0), batch_size=2,
                      seq_len=96, cfg=tl, params=jax.tree.map(jnp.copy,
                                                              params),
                      log=log)

    def port_run(name, n, params):
        data = GraphPathData(n_vertices=8, seed=0, device="cpu")
        return train(tm, data, batch_size=2, seq_len=96,
                     cfg=_loop(tmp_path, name, n), params=params,
                     log=lambda *_: None)

    # JAX writes, the port resumes
    jp2, js2, _ = jax_run("j", 2, jp)
    shutil.copytree(tmp_path / "j", tmp_path / "j_copy")
    fresh = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                 device="cpu")
    opt, _ = restore_train_state(Checkpointer(str(tmp_path / "j")), cfg,
                                 fresh, steps.init_opt_state(fresh))
    _same_tree(lm_params_to_numpy(cfg, fresh), jp2, "restored params")
    _same_tree(adamw_state_to_numpy(cfg, fresh, opt), js2, "restored state")
    tp3, _, th = port_run("j", 3, fresh)
    jp3, _, jh = jax_run("j_copy", 3, jp)
    assert th[0][0] == jh[0][0] == 3
    np.testing.assert_allclose(th[0][1], jh[0][1], rtol=1e-5)
    _same_tree(lm_params_to_numpy(cfg, tp3), jp3, "resumed step", rtol=0,
               atol=1e-5)

    # the port writes, JAX resumes
    tp2, ts2, _ = port_run("t", 2, lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu"))
    shutil.copytree(tmp_path / "t", tmp_path / "t_copy")
    (rp, rs), man = JCheckpointer(str(tmp_path / "t")).restore(
        (jp, jsteps.init_opt_state(jp)))
    assert man["step"] == 2
    assert man["treedef"] == str(jax.tree.structure(
        (jp, jsteps.init_opt_state(jp))))
    _same_tree(rp, lm_params_to_numpy(cfg, tp2), "JAX-restored params")
    _same_tree(rs, adamw_state_to_numpy(cfg, tp2, ts2), "JAX-restored state")
    log = []
    jp3, _, _ = jax_run("t", 3, jp, log.append)
    assert log[0] == "[train] resumed from step 2"
    tp3, _, _ = port_run("t_copy", 3, tp2)
    _same_tree(lm_params_to_numpy(cfg, tp3), jp3, "JAX's resumed step",
               rtol=0, atol=1e-5)


def test_train_runs_on_one_device(tmp_path):
    """``train(mesh=)`` on the (1, 1) mesh of one process: the same losses,
    params, moments and checkpoint bytes as the run without a mesh, bit
    for bit (every collective is the identity), with the params DTensors
    on the mesh; then a resume of the meshed directory restores onto the
    mesh (``restore(shardings=)``) and runs on."""
    import torch.distributed as dist

    tm = build_model(TC.get_config("olmo-1b").smoke())
    data = SyntheticLMData(tm.cfg.vocab)

    def run(name, steps_, mesh=None, seed=0):
        return train(tm, data, batch_size=2, seq_len=32,
                     cfg=_loop(tmp_path, name, steps_),
                     params=tm.init(torch.Generator("cpu").manual_seed(seed)),
                     mesh=mesh, log=lambda *_: None)

    p0, s0, h0 = run("plain", 2)
    mesh = _host_mesh()
    try:
        p1, s1, h1 = run("mesh", 2, mesh)
        assert [l for _, l, _ in h1] == [l for _, l, _ in h0]
        for (n, a), b in zip(p1.named_parameters(), p0.parameters(),
                             strict=True):
            assert a.device_mesh == mesh
            assert torch.equal(_bits(a.to_local()), _bits(b)), n
            assert torch.equal(s1.mu[n].to_local(), s0.mu[n]), n
        step2 = "step_000000002"
        for f in os.listdir(tmp_path / "plain" / step2):
            if f.endswith(".npy"):
                assert filecmp.cmp(tmp_path / "plain" / step2 / f,
                                   tmp_path / "mesh" / step2 / f,
                                   shallow=False), f
        p2, s2, h2 = run("mesh", 3, mesh, seed=9)     # resumes at step 2
        assert [s for s, _, _ in h2] == [3] and int(s2.step) == 3
        assert all(hasattr(p, "placements") for p in p2.parameters())
    finally:
        dist.destroy_process_group()


def test_adamw_state_crosses_both_ways():
    jm, jp, tm, tp = _pair("granite-moe-3b-a800m")
    js = jadamw.init(jp)
    js = js._replace(step=jnp.int32(7), mu=_random_grads(jp, 1.0, 1),
                     nu=_random_grads(jp, 2.0, 2))
    ts = adamw_state_from_numpy(tm.cfg, tp, jax.tree.map(np.asarray, js),
                                device="cpu")
    assert set(ts.mu) == {n for n, _ in tp.named_parameters()}
    _same_tree(adamw_state_to_numpy(tm.cfg, tp, ts), js, "AdamWState")


# ----------------------------------------------------------------------------
# launcher
# ----------------------------------------------------------------------------
def test_launcher_trains_on_the_graph_task_on_the_cpu(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen2-1.5b", "--smoke", "--data", "graph", "--steps", "3",
           "--batch", "2", "--seq", "96", "--device", "cpu", "--ckpt-dir",
           str(tmp_path)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("done; final loss ")
    assert (tmp_path / "step_000000003" / "manifest.json").exists()


def test_the_example_trains_on_the_cpu(tmp_path):
    cmd = [sys.executable, str(ROOT / "examples" / "train_path_lm_torch.py"),
           "--steps", "2", "--batch", "2", "--seq", "96", "--device", "cpu",
           "--ckpt", str(tmp_path)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("loss ")


def test_launcher_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "olmo-1b", "--smoke", "--ckpt-dir",
                      str(tmp_path)])


def test_both_launchers_fail_on_whisper_for_want_of_frames(tmp_path,
                                                           monkeypatch):
    args = ["--arch", "whisper-base", "--smoke", "--steps", "1", "--batch",
            "2", "--seq", "16"]
    with pytest.raises(KeyError, match="frames"):
        tlaunch.main(args + ["--device", "cpu", "--ckpt-dir",
                             str(tmp_path / "t")])
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--ckpt-dir", str(tmp_path / "j")])
    with pytest.raises(KeyError, match="frames"):
        jlaunch.main()
