"""Error-feedback int8 gradient compression for cross-pod reductions; the
port of ``repro.optim.grad_compress``.

Compressing gradients 4x (f32 -> int8 with a per-tensor scale) before a
slow reduction hop, and carrying the quantization residual forward (error
feedback), keeps convergence intact. On one device the reduction is
simulated by quantize -> dequantize, as JAX's plain-jit path does. Trees are
dicts keyed by parameter name (``optim.adamw``). ``torch.round`` rounds
half to even, as ``jnp.round`` does, so both packages emit the same codes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.optim.adamw import named_leaves


class EFState(NamedTuple):
    residual: dict  # name -> f32 tensor


def init(params) -> EFState:
    return EFState(residual={
        n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in named_leaves(params).items()})


def _quant(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.float() * scale


def compress_decompress(grads, ef: EFState):
    """Quantize+dequantize each gradient leaf with error feedback.

    Returns (decompressed_grads, new_EFState). The round-trip is what the
    receiving side of an int8 reduce would see; the residual keeps the
    information the quantizer dropped for the next step.
    """
    newg, newr = {}, {}
    for name, g in grads.items():
        gf = g.float() + ef.residual[name]
        q, s = _quant(gf)
        newg[name] = _dequant(q, s)
        newr[name] = gf - newg[name]
    return newg, EFState(residual=newr)
