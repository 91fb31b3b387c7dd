"""Mamba-2 SSD (state-space duality) block: chunked prefill and O(1)
decode; the port of ``repro.models.ssm``.

Within a chunk of Q tokens the output is a masked quadratic form; across
chunks a linear recurrence carries [H, N, hd] states (arXiv:2405.21060).
JAX's ``lax.scan`` over chunks is a Python loop here, and its five-operand
einsums are staged products (batched matmuls over (batch, chunk, head)),
so no [B, nc, Q, Q, H] intermediate is formed twice. Decode is one
recurrent update: a constant-size state, whatever the context length.

Layout: d_inner = expand * d_model; H = d_inner / headdim heads; state N.
Params per layer: in_proj d -> (2 * d_inner + 2 * N + H), a depthwise
causal conv (width ssm_conv) on the x branch, per-head A (scalar decay),
D skip, the output gated by silu(z), out_proj d_inner -> d. The states
are f32 and the conv tails in the model dtype, as JAX keeps them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, dtype_of, pdict


def _dims(cfg):
    din = cfg.ssm_expand * cfg.d_model
    nh = din // cfg.ssm_headdim
    return din, nh, cfg.ssm_headdim, cfg.ssm_state


def init_ssm(gen, cfg) -> nn.ParameterDict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    din, nh, hd, n = _dims(cfg)
    f32 = {"dtype": torch.float32, "device": gen.device}
    return pdict(
        in_proj=dense_init(gen, (d, 2 * din + 2 * n + nh), dt),
        conv_w=dense_init(gen, (cfg.ssm_conv, din), dt, scale=0.5),
        conv_b=torch.zeros((din,), **f32),
        a_log=torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        dt_bias=torch.zeros((nh,), **f32),
        dskip=torch.ones((nh,), **f32),
        out_proj=dense_init(gen, (din, d), dt))


def _split_proj(cfg, zxbcdt):
    din, nh, hd, n = _dims(cfg)
    z = zxbcdt[..., :din]
    x = zxbcdt[..., din:2 * din]
    bmat = zxbcdt[..., 2 * din:2 * din + n]
    cmat = zxbcdt[..., 2 * din + n:2 * din + 2 * n]
    dt = zxbcdt[..., 2 * din + 2 * n:]
    return z, x, bmat, cmat, dt


def _causal_conv(cfg, p, x):
    """Depthwise causal conv along time in f32. x: [B, S, din]."""
    w = p["conv_w"].float()                       # [K, din]
    k = w.shape[0]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + p["conv_b"]).to(x.dtype)


def apply_ssm(cfg, p, x):
    """Chunked SSD forward. x: [B, S, d] -> (y [B, S, d], final_state
    [B, H, N, hd] f32, conv_tail [B, K-1, din], the pre-conv inputs a
    decode warm-starts from). Raises AssertionError, as JAX's assert does,
    when the chunk min(ssm_chunk, S) does not divide S."""
    b, s, d = x.shape
    din, nh, hd, n = _dims(cfg)
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise AssertionError((s, q))
    nc = s // q

    zxbcdt = x @ p["in_proj"]
    z, xb_raw, bmat, cmat, dtr = _split_proj(cfg, zxbcdt)
    conv_tail = xb_raw[:, s - (cfg.ssm_conv - 1):, :]
    xb = _causal_conv(cfg, p, xb_raw)

    dt = F.softplus(dtr.float() + p["dt_bias"])                 # [B,S,H]
    a = -torch.exp(p["a_log"])                                  # [H]
    xh = xb.float().reshape(b, s, nh, hd)

    # chunk views, heads ahead of time for the batched products
    xc = xh.reshape(b, nc, q, nh, hd).permute(0, 1, 3, 2, 4)    # [B,nc,H,Q,hd]
    bc = bmat.float().reshape(b, nc, q, n)
    cc = cmat.float().reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, nh).permute(0, 1, 3, 2)          # [B,nc,H,Q]
    seg = torch.cumsum(dtc * a[:, None], dim=-1)                # [B,nc,H,Q]

    # intra-chunk: L[i, j] = exp(seg_i - seg_j) for i >= j; masked to
    # -inf before the exp, as JAX does (the j > i differences overflow)
    li = seg[..., :, None] - seg[..., None, :]                  # [B,nc,H,Q,Q]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    att = torch.exp(torch.where(tri, li, -math.inf))
    del li
    # out of place: autograd keeps the exp's output for its backward pass
    att = att * (cc @ bc.transpose(-1, -2))[:, :, None]         # C_i . B_j
    y = att @ (xc * dtc[..., None])                             # [B,nc,H,Q,hd]
    del att

    # chunk-final states: S_c = sum_j exp(seg_Q - seg_j) dt_j B_j x_j^T
    w = torch.exp(seg[..., -1:] - seg) * dtc                    # [B,nc,H,Q]
    sstates = bc.transpose(-1, -2)[:, :, None] @ (xc * w[..., None])
    chunk_decay = torch.exp(seg[..., -1])                       # [B,nc,H]

    h = torch.zeros((b, nh, n, hd), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):             # emit the state BEFORE each chunk
        before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + sstates[:, c]
    h_before = torch.stack(before, 1)                           # [B,nc,H,N,hd]

    # inter-chunk: y_i += exp(seg_i) C_i h_before
    y += torch.exp(seg)[..., None] * (cc[:, :, None] @ h_before)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, s, nh, hd)
    y = y + xh * p["dskip"][None, None, :, None]
    y = (y.reshape(b, s, din) * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"], h, conv_tail


def apply_ssm_decode(cfg, p, x, state, conv_cache):
    """One-token recurrent update.

    x: [B,1,d]; state: [B,H,N,hd] f32; conv_cache: [B,K-1,din]
    -> (y [B,1,d], state', conv_cache'), new tensors as in JAX."""
    b = x.shape[0]
    din, nh, hd, n = _dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z, xb, bmat, cmat, dtr = _split_proj(cfg, zxbcdt)

    w = p["conv_w"].float()
    k = w.shape[0]
    seq = torch.cat([conv_cache.float(), xb.float()], dim=1)
    conv_out = (seq[:, -k:, :] * w).sum(1) + p["conv_b"]
    xcv = F.silu(conv_out)                                      # [B,din]
    conv_cache = seq[:, -(k - 1):, :].to(conv_cache.dtype)

    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"])           # [B,H]
    g = torch.exp(dt * -torch.exp(p["a_log"]))                  # [B,H]
    xh = xcv.reshape(b, nh, hd)
    bv = bmat[:, 0].float()                                     # [B,N]
    cv = cmat[:, 0].float()
    state = state * g[..., None, None] + (
        dt[:, :, None, None] * bv[:, None, :, None] * xh[:, :, None, :])
    y = (cv[:, None, None, :] @ state)[:, :, 0] + xh * p["dskip"][None, :,
                                                                  None]
    y = (y.reshape(b, 1, din) * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"], state, conv_cache
