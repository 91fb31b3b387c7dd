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

On DTensors (a mesh set by ``parallel.sharding.set_activation_mesh``) the
chunked core and the decode step run as ``local_map`` bodies on each
rank's blocks, in the layouts the ``attn_q`` / ``attn_kv`` hooks and
``cache_specs`` pin: heads over "model" where they divide it, else the
sequence (prefill) or the cache length (decode, flash-decoding style: one
max and two sums over "model").
"""
from __future__ import annotations

import torch
from torch import nn
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import (apply_rope, dense_init, dtype_of,
                                       pdict, softcap)
from repro_torch.parallel import sharding as sh

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


def _split_heads(x, n: int, hd: int):
    """[B, S, n * hd] -> [B, S, n, hd]. A DTensor whose last dim is split
    over a mesh dim that does not divide ``n`` (whole heads) is first
    gathered on that dim: a split inside a head has no layout."""
    if isinstance(x, DTensor):
        x = _whole_heads(x, n)
    return x.reshape(*x.shape[:-1], n, hd)


def _whole_heads(g, n: int):
    """``g`` [..., n * hd] with its last dim gathered on every mesh dim
    that does not divide ``n``."""
    mesh = g.device_mesh
    pl = [Replicate() if pi == Shard(g.ndim - 1) and n % mesh.size(i)
          else pi for i, pi in enumerate(g.placements)]
    return g if pl == list(g.placements) else g.redistribute(mesh, pl)


def _merge_heads(x):
    """[B, S, n, hd] -> [B, S, n * hd]. On a DTensor the gradient coming
    back is gathered where it splits inside a head (the projection's
    backward may split it so), so that it unflattens."""
    n = x.shape[2]
    out = x.reshape(*x.shape[:2], n * x.shape[3])
    if isinstance(out, DTensor) and out.requires_grad:
        out.register_hook(lambda g: _whole_heads(g, n))
    return out


def _project_q(cfg, p, x):
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)      # f32 bias, cast to the activations
    q = _split_heads(q, cfg.n_heads, cfg.hd)
    if "qnorm" in p:
        q = _headnorm(cfg, q, p["qnorm"])
    return q


def _project_kv(cfg, p, x):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"].to(k.dtype), v + p["bv"].to(v.dtype)
    k = _split_heads(k, cfg.n_kv, cfg.hd)
    v = _split_heads(v, cfg.n_kv, cfg.hd)
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
                    q_pos0: int = 0, chunk: int = 1024):
    """q: [B,S,H,hd], k/v: [B,T,Kv,hd] -> [B,S,H,hd], query head i reading
    KV head i // (H / Kv).

    Online-softmax scan over KV chunks; ``causal`` masks keys after each
    query, ``window`` > 0 restricts each query to a trailing window
    (sliding-window attention); the queries sit at positions ``q_pos0``
    onwards."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    kv = k.shape[2]
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

    q_ids = torch.arange(q_pos0, q_pos0 + s, dtype=torch.int32, device=dev)
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


def _model_coord(mesh) -> int:
    """This rank's coordinate on the mesh's "model" axis (0 without one)."""
    names = mesh.mesh_dim_names
    return mesh.get_local_rank("model") if "model" in names else 0


def _model_dim(mesh) -> int | None:
    """The index of the mesh's "model" dim (None without one)."""
    names = mesh.mesh_dim_names
    return names.index("model") if "model" in names else None


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a ``local_map``
    body's input gradients become the local tensors of DTensors that
    claim a contiguous layout."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _attend(cfg, q, k, v, *, causal: bool, window: int):
    """``_attend_chunked``, or on DTensors its sharded form: q pinned by
    the ``attn_q`` hook (heads over "model" when they divide it, else the
    sequence), k/v by ``attn_kv`` (their heads over "model" where the
    query heads are and the KV heads divide too, else whole on every
    model rank), then the chunked core on each rank's local blocks
    (``local_map``), which needs no collective: a rank's query heads read
    the KV heads of their groups, a rank's query rows sit at its sequence
    offset."""
    if not isinstance(q, DTensor):
        return _attend_chunked(cfg, q, k, v, causal=causal, window=window)

    mesh = q.device_mesh
    q = sh.shard_activation(q, "attn_q")
    b, t, kvh, hd = k.shape
    kv_spec = sh.activation_spec((b, t, q.shape[2], hd), "attn_kv")
    md = _model_dim(mesh)
    heads = md is not None and q.placements[md] == Shard(2)
    if kv_spec[2] is not None and not sh._fits(mesh, kvh, kv_spec[2]):
        kv_spec = sh.P(kv_spec[0], None, None, None)
    k = sh.constrain(k, kv_spec)
    v = sh.constrain(v, kv_spec)
    seq = md is not None and q.placements[md] == Shard(1)
    r = _model_coord(mesh)
    h_all, g = cfg.n_heads, cfg.n_heads // cfg.n_kv

    split = mesh.size() > 1      # one rank's strides are the global ones

    def local(ql, kl, vl):
        if split:
            ql, kl, vl = (_DenseGrad.apply(t) for t in (ql, kl, vl))
        hl = ql.shape[2]
        if heads and kl.shape[2] == kvh and hl < h_all:
            h0 = r * hl              # this rank's query heads, whole KV
            if hl % g == 0:
                kl = kl[:, :, h0 // g:(h0 + hl) // g]
                vl = vl[:, :, h0 // g:(h0 + hl) // g]
            elif g % hl == 0:
                kl = kl[:, :, h0 // g:h0 // g + 1]
                vl = vl[:, :, h0 // g:h0 // g + 1]
            else:
                idx = (h0 + torch.arange(hl, device=kl.device)) // g
                kl, vl = kl[:, :, idx], vl[:, :, idx]
        return _attend_chunked(cfg, ql, kl, vl, causal=causal,
                               window=window,
                               q_pos0=r * ql.shape[1] if seq else 0)

    # where k/v are whole on a mesh dim that splits q, each rank's k/v
    # gradient covers its own queries: a partial sum over that dim
    kv_grad = [Partial() if pk == Replicate() and pq != Replicate() else pk
               for pq, pk in zip(q.placements, k.placements)]
    out = local_map(local, out_placements=list(q.placements),
                    in_placements=(list(q.placements), list(k.placements),
                                   list(v.placements)),
                    in_grad_placements=(list(q.placements), kv_grad,
                                        kv_grad),
                    device_mesh=mesh)(q, k, v)
    if not seq:
        return out
    # the projection flattens [B, S]: a split sequence would become a
    # strided split that DTensor cannot multiply, so gather it here
    return out.redistribute(mesh, [Replicate() if pl == Shard(1) else pl
                                   for pl in out.placements])


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
    out = _attend(cfg, q, k, v, causal=causal, window=window)
    b, s = x.shape[0], x.shape[1]
    out = _merge_heads(out) @ p["wo"]
    return out, (k, v)


def attn_decode(cfg, p, x, cache_k, cache_v, pos, *, window=0):
    """Single-token decode. x: [B,1,d]; cache_k/v: [B,L,Kv,hd]; pos: int.

    Writes the new token's k/v into the caches IN PLACE (JAX returns
    updated copies; its unrolled serving step updates them in place too)
    and returns (out [B,1,d], cache_k, cache_v). Global layers index the
    cache by absolute position (mask ids <= pos). A sliding-window layer
    whose cache length equals its window uses it as a ring: the token
    writes slot pos % L, keys keep their absolute rotation, and the mask
    ids <= pos only gates the warm-up. DTensor caches (laid out by
    ``parallel.sharding.cache_specs``) take ``_decode_sharded``.
    """
    b = x.shape[0]
    L = cache_k.shape[1]
    pos = int(pos)
    ring = bool(window) and window <= L and L != 0 and window == L
    q = _project_q(cfg, p, x)              # [B,1,H,hd]
    k_new, v_new = _project_kv(cfg, p, x)  # [B,1,Kv,hd]
    ppos = sh.replicate_like(
        torch.full((1, 1), pos, dtype=torch.int32, device=x.device), q)
    q = apply_rope(cfg, q, ppos)
    k_new = apply_rope(cfg, k_new, ppos)
    # dynamic_update_slice clamps its start index into the cache
    widx = min(max((pos % L) if ring else pos, 0), L - 1)
    mask_window = window if (window and not ring) else 0
    if isinstance(cache_k, DTensor):
        out = _decode_sharded(cfg, q, k_new, v_new, cache_k, cache_v, pos,
                              widx, mask_window)
        return _merge_heads(out).to(x.dtype) @ p["wo"], cache_k, cache_v
    out = _decode_core(cfg, q, k_new, v_new, cache_k, cache_v, pos, widx,
                       mask_window)
    out = out.reshape(b, 1, cfg.n_heads * cfg.hd).to(x.dtype) @ p["wo"]
    return out, cache_k, cache_v


def _decode_core(cfg, q, k_new, v_new, cache_k, cache_v, pos, widx,
                 window, l0=0, group=None):
    """The decode step on plain tensors: write slot ``widx`` (global; this
    block holds cache positions [l0, l0 + L)), then attend. q [B,1,h,hd]
    with h query heads over the block's KV heads. ``group``: the process
    group that holds the other blocks of the cache's length, reduced over
    (flash decoding: each block's partial softmax, then one max and two
    sums); None when this block is the whole length. -> [B,Kv,g,hd] f32."""
    b = q.shape[0]
    L = cache_k.shape[1]
    if l0 <= widx < l0 + L:
        cache_k[:, widx - l0] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, widx - l0] = v_new[:, 0].to(cache_v.dtype)
    kv = cache_k.shape[2]
    g = q.shape[2] // kv
    qf = (q.float() * _qscale(cfg)).to(cache_k.dtype).view(b, kv, g, cfg.hd)
    # one product per KV head, reading the cache's [B, L, hd] slice where
    # it lies: no copy of the cache in any dtype
    sc = torch.stack([_bmm_f32(qf[:, j], cache_k[:, :, j].transpose(1, 2))
                      for j in range(kv)], dim=1)          # [B,Kv,g,L] f32
    sc = softcap(sc, cfg.attn_softcap)
    ids = torch.arange(l0, l0 + L, dtype=torch.int32, device=q.device)
    mask = ids <= pos
    if window:
        mask &= (pos - ids) < window
    sc = torch.where(mask, sc, NEG_INF)
    if group is None:
        pr = torch.softmax(sc, dim=-1).to(cache_v.dtype)
        return torch.stack([_bmm_f32(pr[:, j], cache_v[:, :, j])
                            for j in range(kv)], dim=1)    # [B,Kv,g,hd] f32
    m = fc.all_reduce(sc.amax(-1), "max", group)
    e = torch.exp(sc - m[..., None])
    den = fc.all_reduce(e.sum(-1), "sum", group)
    pr = e.to(cache_v.dtype)
    num = torch.stack([_bmm_f32(pr[:, j], cache_v[:, :, j])
                       for j in range(kv)], dim=1)
    return fc.all_reduce(num, "sum", group) / den[..., None]


def _decode_sharded(cfg, q, k_new, v_new, cache_k, cache_v, pos, widx,
                    window):
    """``_decode_core`` on each rank's block of DTensor caches
    [B, L, Kv, hd] (``local_map``): batch over the data axes; KV heads over
    "model", with the query heads of their groups, or else the length over
    "model", each rank writing the slot only where it holds it and the
    softmax reduced over "model" (flash decoding). -> [B,1,H,hd] f32."""
    mesh = cache_k.device_mesh
    cp = list(cache_k.placements)
    md = _model_dim(mesh)
    # a length split over one rank is the whole length: the plain softmax
    length = md is not None and cp[md] == Shard(1) and mesh.size(md) > 1
    if any(pl not in (Replicate(), Shard(0), Shard(1), Shard(2))
           for pl in cp):
        raise NotImplementedError(f"decode on a cache laid out {cp}")
    # the new token's q/k/v: the cache's batch split, heads as the cache's
    new = [Replicate() if pl == Shard(1) else pl for pl in cp]
    q = q.redistribute(mesh, new)
    k_new = k_new.redistribute(mesh, new)
    v_new = v_new.redistribute(mesh, new)
    r = _model_coord(mesh)
    b, hd = q.shape[0], cfg.hd

    def local(ql, kl, vl, ckl, cvl):
        ln = ckl.shape[1]
        out = _decode_core(cfg, ql, kl, vl, ckl, cvl, pos, widx, window,
                           l0=r * ln if length else 0,
                           group=(mesh, md) if length else None)
        return out.reshape(ql.shape[0], 1, ql.shape[2], hd)

    return local_map(local, out_placements=new,
                     in_placements=(new, new, new, cp, cp),
                     device_mesh=mesh)(q, k_new, v_new, cache_k, cache_v)
