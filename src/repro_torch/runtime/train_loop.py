"""Fault-tolerant training loop: checkpoint/restart, stragglers, resume; the
port of ``repro.runtime.train_loop``.

The loop is deliberately restart-idempotent: all state lives in
(params, opt_state, step); data is a pure function of step; a crash at any
point resumes from the last published checkpoint with identical semantics.
``simulate_failure_at`` injects a crash for the fault-tolerance tests.

A checkpoint holds the JAX package's tree: ``(params, AdamWState(step, mu,
nu))`` with each stack's layers stacked over its groups, in JAX's leaf
order (``convert.jax_layout``). So a JAX ``train()`` resumes from the
port's directory and the port from a JAX one; the port restores bfloat16
leaves bit for bit (ROADMAP.md queue C item C3: JAX's restore cannot cast
them back). The loop runs on the params' device; without params it draws
them on the card from a generator seeded 0.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import from_jax_tree, to_jax_tree
from repro_torch.launch import steps as steps_mod
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.fault import FailurePolicy, Heartbeat, StragglerDetector


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    log_every: int = 10
    microbatches: int = 1
    lr: float = 3e-4
    simulate_failure_at: int | None = None
    straggler_sleep_at: int | None = None  # inject a slow step (tests)


class SimulatedFailure(RuntimeError):
    pass


def train_tree(cfg, params, opt_state: AdamWState, stack=torch.stack):
    """``(params, opt_state)`` in the JAX package's tree and leaf order."""
    return (to_jax_tree(cfg, params, stack=stack),
            AdamWState(step=opt_state.step,
                       mu=to_jax_tree(cfg, params, opt_state.mu, stack),
                       nu=to_jax_tree(cfg, params, opt_state.nu, stack)))


def meta_stack(ts):
    """``train_tree``'s ``stack`` for a restore template: the stacked leaf's
    shape and dtype on the meta device, holding no memory."""
    return torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype,
                       device="meta")


def restore_train_state(ckpt: Checkpointer, cfg, params,
                        opt_state: AdamWState):
    """Loads the latest checkpoint into ``params`` and ``opt_state`` in
    place. Returns (opt_state, manifest)."""
    template = train_tree(cfg, params, opt_state, stack=meta_stack)
    (tp, ts), manifest = ckpt.restore(template,
                                      device=opt_state.step.device)
    with torch.no_grad():
        for dst, tree in ((dict(params.named_parameters()), tp),
                          (opt_state.mu, ts.mu), (opt_state.nu, ts.nu)):
            for name, t in from_jax_tree(cfg, params, tree).items():
                dst[name].copy_(t)
    return opt_state._replace(step=ts.step), manifest


def train(model, data_source, *, batch_size: int, seq_len: int,
          cfg: TrainLoopConfig, params=None, mesh=None, shardings=None,
          log=print):
    """Runs/resumes training; returns (params, opt_state, history)."""
    if mesh is not None or shardings is not None:
        raise TypeError("train() runs on one device: a mesh and its "
                        "shardings are ROADMAP.md queue A12 (iv)")
    ckpt = Checkpointer(cfg.checkpoint_dir)
    step0 = 0
    if params is None:
        params = model.init()
    dev = next(params.parameters()).device
    opt_state = steps_mod.init_opt_state(params)

    latest = ckpt.latest_step()
    if latest is not None:
        opt_state, manifest = restore_train_state(ckpt, model.cfg, params,
                                                  opt_state)
        step0 = manifest["step"]
        log(f"[train] resumed from step {step0}")

    train_step = steps_mod.make_train_step(
        model, lr=cfg.lr, microbatches=cfg.microbatches, remat=True)

    hb, straggler, policy = Heartbeat(), StragglerDetector(), FailurePolicy()
    history = []
    step = step0
    while step < cfg.total_steps:
        t0 = time.time()
        tokens = data_source.batch(step, batch_size, seq_len)
        if cfg.straggler_sleep_at == step:
            time.sleep(0.2)  # injected slow data read
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if cfg.simulate_failure_at == step:
            raise SimulatedFailure(f"injected failure at step {step}")
        dt = time.time() - t0
        hb.tick("worker0")
        if straggler.observe(dt):
            log(f"[train] step {step}: straggler ({dt:.3f}s vs ewma "
                f"{straggler.ewma_s:.3f}s) — mitigation: skip-and-log")
        step += 1
        if step % cfg.log_every == 0 or step == cfg.total_steps:
            loss = float(metrics["loss"])
            history.append((step, loss, dt))
            log(f"[train] step {step} loss {loss:.4f} ({dt*1000:.0f} ms)")
        if step % cfg.checkpoint_every == 0 or step == cfg.total_steps:
            ckpt.save(step, train_tree(model.cfg, params, opt_state))
    ckpt.wait()
    return params, opt_state, history
