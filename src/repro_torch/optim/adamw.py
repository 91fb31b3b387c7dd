"""AdamW with decoupled weight decay; the port of ``repro.optim.adamw``.

Trees are the port's: an ``nn.Module`` of parameters (its
``named_parameters``) or a flat dict of tensors, and the gradients, moments
and residuals are dicts keyed by the same names. The update runs leaf by
leaf, in place and under ``torch.no_grad()``: the params and the moments
are written where they lie, which stands in for JAX's buffer donation, so
the optimizer never holds a second copy of the state.

Weight decay follows the JAX package's rule, "decay matrices only", on
JAX's layout: JAX stacks the layers of a trunk (and of an encoder or
decoder) into one leaf with a leading layer axis, where the port keeps one
module a layer in an ``nn.ModuleList``. So a leaf under a ModuleList counts
one more dimension here (``stacked_ndim``): each layer's norm scales and
q/k/v biases are decayed, as in JAX, and ``final_norm`` is not.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32, 0-d
    mu: dict              # name -> f32 tensor
    nu: dict


def named_leaves(tree) -> dict:
    """{name: tensor} of an ``nn.Module``'s parameters, or a flat dict of
    tensors as it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def stacked_ndim(name: str, p: torch.Tensor) -> int:
    """The leaf's rank in the JAX package's layout, where each ModuleList
    (a numbered component of ``name``) is one stacked leaf."""
    return p.ndim + any(part.isdigit() for part in name.split("."))


def init(params) -> AdamWState:
    leaves = named_leaves(params)
    dev = next(iter(leaves.values())).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={n: zeros(p) for n, p in leaves.items()},
                      nu={n: zeros(p) for n, p in leaves.items()})


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """Returns (params, new_state), both written in place. ``lr`` may be a
    scalar or schedule value."""
    step = state.step + 1

    scale = None
    if grad_clip:
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in grads.values()))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

    sf = step.float()
    b1c = 1.0 - torch.pow(b1, sf)
    b2c = 1.0 - torch.pow(b2, sf)

    for name, p in named_leaves(params).items():
        gf = grads[name].float()
        if scale is not None:
            gf = gf * scale
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * gf.square())
        delta = (m / b1c) / ((v / b2c).sqrt_() + eps)
        pf = p.float()
        if stacked_ndim(name, p) >= 2:  # decay matrices only
            delta += weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
