"""Step functions driven by the runtime loops; the port of
``repro.launch.steps``.

  train_step(params, opt_state, batch)     -> (params, opt_state', metrics)
  prefill_step(params, batch)              -> (last_logits, caches)
  decode_step(params, caches, tokens, pos) -> (logits, caches')

The train step takes its gradients with autograd (the counterpart of
``jax.value_and_grad``): it turns gradients on for the params it is given,
which ``Model.init`` draws frozen for serving. Microbatches
(``microbatches > 1``) accumulate f32 gradients in a Python loop where JAX
scans. The params and the optimizer's moments are updated in place
(``optim.adamw``), where JAX donates their buffers.
"""
from __future__ import annotations

import torch

from repro_torch.optim import adamw, grad_compress


def make_train_step(model, *, lr=3e-4, microbatches: int = 1,
                    remat: bool = True, compress: bool = False,
                    weight_decay: float = 0.1, grad_specs=None):
    """``grad_specs``: optional {parameter name: ``NamedSharding``} (the
    param shardings). Each gradient, and the microbatch accumulator, is
    pinned to its parameter's placement with ``redistribute`` (a partial
    sum becomes a reduce-scatter), so the optimizer runs ZeRO-sharded
    where the params are."""

    def pin(grads):
        if grad_specs is None:
            return grads
        return {n: g.redistribute(grad_specs[n].mesh,
                                  grad_specs[n].placements)
                for n, g in grads.items()}

    def grad_fn(params, leaves, batch):
        loss, metrics = model.loss_and_metrics(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), metrics, pin(dict(zip(leaves, grads)))

    def train_step(params, opt_state, batch):
        leaves = adamw.named_leaves(params)
        for p in leaves.values():
            p.requires_grad_(True)
        if microbatches == 1:
            loss, metrics, grads = grad_fn(params, leaves, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            b = next(iter(batch.values())).shape[0] // microbatches
            grads = pin({n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in leaves.items()})
            loss = 0.0
            for i in range(microbatches):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                l, _, g = grad_fn(params, leaves, mb)
                for n, gi in g.items():
                    grads[n] += gi
                loss = loss + l
            grads = {n: g / microbatches for n, g in grads.items()}
            loss = loss / microbatches
            metrics = {"loss": loss, "aux": torch.zeros_like(loss)}

        if compress:
            grads, ef = grad_compress.compress_decompress(grads,
                                                          opt_state["ef"])
            params, adam = adamw.update(params, grads, opt_state["adam"],
                                        lr=lr, weight_decay=weight_decay)
            return params, {"adam": adam, "ef": ef}, metrics

        params, opt_state = adamw.update(params, grads, opt_state, lr=lr,
                                         weight_decay=weight_decay)
        return params, opt_state, metrics

    return train_step


def init_opt_state(model_params, *, compress: bool = False):
    if compress:
        return {"adam": adamw.init(model_params),
                "ef": grad_compress.init(model_params)}
    return adamw.init(model_params)


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, caches, tokens, pos):
        return model.decode_step(params, caches, tokens, pos)

    return decode_step
