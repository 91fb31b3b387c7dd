"""GQA attention: chunked online-softmax forward, KV-cache decode, options;
the port of ``repro.models.attention``.

One implementation serves every arch via config flags: qk_norm (qwen3,
olmoe), qkv_bias (qwen2), attn_softcap (gemma2), sliding_window with
local/global alternation (gemma2, recurrentgemma), MQA kv = 1
(recurrentgemma), and non-causal, rotation-free and cross attention
(whisper). JAX's ``attn_decode(update_cache=)``, which no JAX caller
passes, is not ported.

The prefill path scans KV chunks of at most 1,024 with a running (max,
denom, acc), in JAX's chunk order and with its finite ``NEG_INF`` mask, so
no S x S score matrix is held. Every score and every P @ V product takes
its operands in the stored dtype and accumulates in f32, as JAX's
``preferred_element_type=jnp.float32`` does: on the card through
``torch.bmm(..., out_dtype=torch.float32)``; the CPU has no kernel for that
overload, so there the operands go up to f32 first (a product of two bf16
values is exact in f32). Query heads are grouped under their KV head
rather than KV repeated to every head: the same dot products, and decode
reads each KV head of the cache in place, one batched product per KV head,
with no copy of the cache.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (apply_rope, dense_init, dtype_of,
                                       pdict, softcap)

NEG_INF = -2.3819763e38


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------
def init_attn(gen, cfg, *, cross: bool = False) -> nn.ParameterDict:
    """A cross-attention layer (``cross=True``) has no q/k/v bias and no
    q/k norm, as in JAX."""
    dt = dtype_of(cfg)
    d, hd = cfg.d_model, cfg.hd
    qd, kvd = cfg.n_heads * hd, cfg.n_kv * hd
    p = {"wq": dense_init(gen, (d, qd), dt),
         "wk": dense_init(gen, (d, kvd), dt),
         "wv": dense_init(gen, (d, kvd), dt),
         "wo": dense_init(gen, (qd, d), dt)}
    f32 = {"dtype": torch.float32, "device": gen.device}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((qd,), **f32)
        p["bk"] = torch.zeros((kvd,), **f32)
        p["bv"] = torch.zeros((kvd,), **f32)
    if cfg.qk_norm and not cross:
        p["qnorm"] = torch.ones((hd,), **f32)
        p["knorm"] = torch.ones((hd,), **f32)
    return pdict(**p)


def _project_q(cfg, p, x):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)      # f32 bias, cast to the activations
    b, s, _ = q.shape
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    if "qnorm" in p:
        q = _headnorm(cfg, q, p["qnorm"])
    return q


def _project_kv(cfg, p, x):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"].to(k.dtype), v + p["bv"].to(v.dtype)
    b, s, _ = k.shape
    k = k.reshape(b, s, cfg.n_kv, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv, cfg.hd)
    if "knorm" in p:
        k = _headnorm(cfg, k, p["knorm"])
    return k, v


def _headnorm(cfg, x, scale):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * scale).to(x.dtype)


def _qscale(cfg):
    return cfg.query_scale if cfg.query_scale else cfg.hd ** -0.5


def _bmm_acc(a, b):
    """[N, M, K] @ [N, K, P] of bf16 / f16 inputs -> f32, accumulated in
    f32 (on the CPU, where ``bmm``'s ``out_dtype`` overload has no kernel,
    through an exact upcast)."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _BmmF32(torch.autograd.Function):
    """``_bmm_acc`` with a gradient (``bmm``'s ``out_dtype`` overload has
    none): dA = dY Bᵀ and dB = Aᵀ dY by the same product, dY cast to the
    inputs' dtype and each result cast back to its input's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_acc(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        dy = dy.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _bmm_acc(dy, b.transpose(1, 2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _bmm_acc(a.transpose(1, 2), dy).to(b.dtype)
        return da, db


def _bmm_f32(a, b):
    """[N, M, K] @ [N, K, P] -> f32 [N, M, P], accumulated in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _BmmF32.apply(a, b)
    return _bmm_acc(a, b)


# ----------------------------------------------------------------------------
# chunked attention core (prefill)
# ----------------------------------------------------------------------------
def _pick_chunk(t: int, chunk: int) -> int:
    """Largest divisor of t that is <= chunk (KV-chunk length)."""
    if t <= chunk:
        return t
    for c in range(chunk, 0, -1):
        if t % c == 0:
            return c
    return t


def _attend_chunked(cfg, q, k, v, *, causal: bool = True, window: int,
                    chunk: int = 1024):
    """q: [B,S,H,hd], k/v: [B,T,Kv,hd] -> [B,S,H,hd].

    Online-softmax scan over KV chunks; ``causal`` masks keys after each
    query, ``window`` > 0 restricts each query to a trailing window
    (sliding-window attention)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kv = cfg.n_kv
    g = h // kv
    ck = _pick_chunk(t, chunk)
    nck = t // ck
    dev = q.device

    # q/k/v stay in the model dtype, products accumulate in f32
    cdt = k.dtype
    qf = (q.float() * _qscale(cfg)).to(cdt)
    # [B*Kv, g*S, hd]: head kv*g + j of q reads KV head kv
    qg = qf.view(b, s, kv, g, hd).permute(0, 2, 3, 1, 4).reshape(
        b * kv, g * s, hd)
    kt = k.permute(0, 2, 1, 3).reshape(b * kv, t, hd)
    vt = v.permute(0, 2, 1, 3).reshape(b * kv, t, hd)

    q_ids = torch.arange(s, dtype=torch.int32, device=dev)
    m = torch.full((b * kv, g, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b * kv, g, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b * kv, g, s, hd), dtype=torch.float32, device=dev)
    for c in range(nck):
        kci = kt[:, c * ck:(c + 1) * ck]
        vci = vt[:, c * ck:(c + 1) * ck]
        sc = _bmm_f32(qg, kci.transpose(1, 2)).view(b * kv, g, s, ck)
        sc = softcap(sc, cfg.attn_softcap)
        kv_ids = c * ck + torch.arange(ck, dtype=torch.int32, device=dev)
        mask = torch.ones((s, ck), dtype=torch.bool, device=dev)
        if causal:
            mask &= kv_ids[None, :] <= q_ids[:, None]
        if window:
            mask &= (q_ids[:, None] - kv_ids[None, :]) < window
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = _bmm_f32(p.to(cdt).view(b * kv, g * s, ck), vci)
        acc = acc * corr[..., None] + pv.view(b * kv, g, s, hd)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.to(q.dtype).view(b, kv, g, s, hd).permute(0, 3, 1, 2, 4)
    return out.reshape(b, s, h, hd)


# ----------------------------------------------------------------------------
# public forward paths
# ----------------------------------------------------------------------------
def attn_forward(cfg, p, x, positions, *, causal=True, window=0,
                 memory=None, use_rope=True):
    """Full-sequence attention (prefill / training forward / encoder /
    cross).

    x: [B,S,d]; positions: int [S]; memory: [B,T,d], the k/v source of
    cross attention (never rotated). Returns (out [B,S,d], (k, v) cache
    entries [B,T,Kv,hd], k after its rotation)."""
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x if memory is None else memory)
    if use_rope and memory is None:
        q = apply_rope(cfg, q, positions[None, :])
        k = apply_rope(cfg, k, positions[None, :])
    out = _attend_chunked(cfg, q, k, v, causal=causal, window=window)
    b, s = x.shape[0], x.shape[1]
    out = out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    return out, (k, v)


def attn_decode(cfg, p, x, cache_k, cache_v, pos, *, window=0):
    """Single-token decode. x: [B,1,d]; cache_k/v: [B,L,Kv,hd]; pos: int.

    Writes the new token's k/v into the caches IN PLACE (JAX returns
    updated copies; its unrolled serving step updates them in place too)
    and returns (out [B,1,d], cache_k, cache_v). Global layers index the
    cache by absolute position (mask ids <= pos). A sliding-window layer
    whose cache length equals its window uses it as a ring: the token
    writes slot pos % L, keys keep their absolute rotation, and the mask
    ids <= pos only gates the warm-up.
    """
    b = x.shape[0]
    L = cache_k.shape[1]
    pos = int(pos)
    ring = bool(window) and window <= L and L != 0 and window == L
    q = _project_q(cfg, p, x)              # [B,1,H,hd]
    k_new, v_new = _project_kv(cfg, p, x)  # [B,1,Kv,hd]
    ppos = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(cfg, q, ppos)
    k_new = apply_rope(cfg, k_new, ppos)
    # dynamic_update_slice clamps its start index into the cache
    widx = min(max((pos % L) if ring else pos, 0), L - 1)
    cache_k[:, widx] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, widx] = v_new[:, 0].to(cache_v.dtype)

    kv = cfg.n_kv
    g = cfg.n_heads // kv
    qf = (q.float() * _qscale(cfg)).to(cache_k.dtype).view(b, kv, g, cfg.hd)
    # one product per KV head, reading the cache's [B, L, hd] slice where
    # it lies: no copy of the cache in any dtype
    sc = torch.stack([_bmm_f32(qf[:, j], cache_k[:, :, j].transpose(1, 2))
                      for j in range(kv)], dim=1)          # [B,Kv,g,L] f32
    sc = softcap(sc, cfg.attn_softcap)
    ids = torch.arange(L, dtype=torch.int32, device=x.device)
    mask = ids <= pos
    if window and not ring:
        mask &= (pos - ids) < window
    sc = torch.where(mask, sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(cache_v.dtype)
    out = torch.stack([_bmm_f32(pr[:, j], cache_v[:, :, j])
                       for j in range(kv)], dim=1)         # [B,Kv,g,hd] f32
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd).to(x.dtype) @ p["wo"]
    return out, cache_k, cache_v
