"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427); the
port of ``repro.models.rglru``.

Block: x -> [branch a: linear -> conv1d(4) -> RG-LRU] * gelu(branch b) -> out.
RG-LRU per channel:  r_t = sigmoid(W_a x_t + b_a);  i_t = sigmoid(W_x x_t + b_x)
                     a_t = exp(c * softplus(lam) * (-r_t))        (c = 8)
                     h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The prefill solves the diagonal linear recurrence with a log-depth
doubling scan over time (Hillis-Steele: ceil(log2 S) rounds, each
combining every position with the one 2^r before it). JAX's
``associative_scan`` combines in another tree, so the two round their f32
sums in another order. Decode is one elementwise update. Every gelu is
the tanh approximation, ``jax.nn.gelu``'s default. The recurrent state is
f32 and the conv tail in the model dtype, as JAX keeps them. JAX's
``apply_rglru(h0=)``, which no JAX caller passes, is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, dtype_of, pdict

_C = 8.0


def init_rglru(gen, cfg) -> nn.ParameterDict:
    dt = dtype_of(cfg)
    d, dl = cfg.d_model, cfg.d_lru
    f32 = {"dtype": torch.float32, "device": gen.device}
    return pdict(
        in_x=dense_init(gen, (d, dl), dt),        # recurrent branch input
        in_g=dense_init(gen, (d, dl), dt),        # multiplicative gate branch
        conv_w=dense_init(gen, (cfg.ssm_conv, dl), dt, scale=0.5),
        conv_b=torch.zeros((dl,), **f32),
        w_a=dense_init(gen, (dl, dl), dt),
        b_a=torch.zeros((dl,), **f32),
        w_i=dense_init(gen, (dl, dl), dt),
        b_i=torch.zeros((dl,), **f32),
        lam=torch.full((dl,), 0.7, **f32),
        out=dense_init(gen, (dl, d), dt))


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gates(p, u):
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(uf @ p["w_i"].float() + p["b_i"])
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * uf)
    return a, gated


def _conv(p, u, tail=None):
    """Causal depthwise conv, optionally warm-started with a cached tail:
    (out in u's dtype, the new tail in u's dtype)."""
    w = p["conv_w"].float()
    k = w.shape[0]
    uf = u.float()
    if tail is None:
        pad = torch.zeros((u.shape[0], k - 1, u.shape[2]),
                          dtype=torch.float32, device=u.device)
    else:
        pad = tail.float()
    seq = torch.cat([pad, uf], dim=1)
    out = sum(seq[:, i:i + u.shape[1], :] * w[i] for i in range(k))
    return (out + p["conv_b"]).to(u.dtype), seq[:, -(k - 1):, :].to(u.dtype)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling:
    after round r every position holds the composition of the 2^(r+1)
    steps ending at it. Each round builds new tensors (autograd keeps the
    old ones for the backward pass)."""
    shift = 1
    while shift < a.shape[1]:
        # (a1, b1) then (a2, b2) compose to (a1 a2, b1 a2 + b2)
        b = torch.cat([b[:, :shift],
                       b[:, :-shift] * a[:, shift:] + b[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def apply_rglru(cfg, p, x):
    """x: [B,S,d] -> (y [B,S,d], h_last [B,d_lru] f32, conv_tail
    [B,K-1,d_lru])."""
    u = x @ p["in_x"]
    g = _gelu((x @ p["in_g"]).float())
    u, conv_tail = _conv(p, u)
    a, gated = _gates(p, u)                      # [B,S,dl] each (f32)
    h = linear_scan(a, gated)                    # [B,S,dl]
    y = (h * g).to(x.dtype) @ p["out"]
    return y, h[:, -1, :], conv_tail


def apply_rglru_decode(cfg, p, x, h, conv_cache):
    """One-token update. x: [B,1,d]; h: [B,d_lru]; conv_cache:
    [B,K-1,d_lru] -> (y, h', conv_cache'), new tensors as in JAX."""
    u = x @ p["in_x"]
    g = _gelu((x @ p["in_g"]).float())
    u, conv_cache = _conv(p, u, tail=conv_cache)
    a, gated = _gates(p, u)                      # [B,1,dl]
    h = a[:, 0] * h.float() + gated[:, 0]
    y = (h[:, None, :] * g).to(x.dtype) @ p["out"]
    return y, h, conv_cache
