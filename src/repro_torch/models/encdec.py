"""Whisper-style encoder-decoder backbone (the conv audio frontend is a
stub); the port of ``repro.models.encdec``.

``frames`` are precomputed frame embeddings [B, F, d] (Whisper's conv1d x 2
+ GELU frontend is a modality stub, as in JAX). The encoder is a
bidirectional transformer over the frames with sinusoidal positions; the
decoder is a causal transformer with cross attention. Decode carries a
self-attention KV cache, written in place, and the cross-attention K/V of
the encoder output, fixed; its cross attention runs in f32, as JAX's does.

Params keep JAX's names; JAX stacks ``enc`` and ``dec`` over layers, and
here each layer is its own module in an ``nn.ModuleList``. Caches keep
JAX's structure: ((k, v) self caches [L, B, S, Kv, hd], (k, v) cross K/V
[L, B, F, Kv, hd]).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as sh


def init_encdec(gen, cfg) -> nn.ModuleDict:
    dev = gen.device

    def enc_layer():
        return nn.ModuleDict({
            "norm1": L.init_norm(cfg, cfg.d_model, dev),
            "attn": attn.init_attn(gen, cfg),
            "norm2": L.init_norm(cfg, cfg.d_model, dev),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff)})

    def dec_layer():
        return nn.ModuleDict({
            "norm1": L.init_norm(cfg, cfg.d_model, dev),
            "self": attn.init_attn(gen, cfg),
            "norm_x": L.init_norm(cfg, cfg.d_model, dev),
            "cross": attn.init_attn(gen, cfg, cross=True),
            "norm2": L.init_norm(cfg, cfg.d_model, dev),
            "mlp": L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff)})

    return nn.ModuleDict({
        "embed": L.init_embed(gen, cfg),
        "enc": nn.ModuleList(enc_layer() for _ in range(cfg.enc_layers)),
        "enc_norm": L.init_norm(cfg, cfg.d_model, dev),
        "dec": nn.ModuleList(dec_layer() for _ in range(cfg.n_layers)),
        "dec_norm": L.init_norm(cfg, cfg.d_model, dev)})


def _res(x, y):
    """x + y, pinned to the batch layout (a no-op without a mesh)."""
    return sh.shard_activation(x + y, "hidden")


def encode(cfg, params, frames):
    """frames: [B, F, d] (stub embeddings) -> [B, F, d]."""
    f = frames.shape[1]
    frames = sh.shard_activation(frames, "hidden")
    pe = L.sinusoidal_positions(f, cfg.d_model, frames.device).to(
        frames.dtype)[None]
    x = frames + sh.replicate_like(pe, frames)
    positions = sh.replicate_like(
        torch.arange(f, dtype=torch.int32, device=frames.device), x)
    for p in params["enc"]:
        p = sh.fsdp_gather(p)
        h = L.apply_norm(cfg, p["norm1"], x)
        a, _ = attn.attn_forward(cfg, p["attn"], h, positions, causal=False,
                                 use_rope=False)
        x = _res(x, a)
        h = L.apply_norm(cfg, p["norm2"], x)
        x = _res(x, L.apply_mlp(cfg, p["mlp"], h))
    return L.apply_norm(cfg, params["enc_norm"], x)


def decode_fwd(cfg, params, tokens, enc_out, *, want_cache: bool):
    """Full decoder pass. tokens: [B,S] -> (logits [B,S,V], caches | None)."""
    embed = sh.fsdp_gather(params["embed"])
    x = sh.shard_activation(L.embed_tokens(cfg, embed, tokens), "hidden")
    positions = sh.replicate_like(torch.arange(
        tokens.shape[1], dtype=torch.int32, device=x.device), x)
    kvs, ckvs = [], []
    for p in params["dec"]:
        p = sh.fsdp_gather(p)
        h = L.apply_norm(cfg, p["norm1"], x)
        a, kv = attn.attn_forward(cfg, p["self"], h, positions, causal=True)
        x = _res(x, a)
        h = L.apply_norm(cfg, p["norm_x"], x)
        c, ckv = attn.attn_forward(cfg, p["cross"], h, positions,
                                   causal=False, memory=enc_out,
                                   use_rope=False)
        x = _res(x, c)
        h = L.apply_norm(cfg, p["norm2"], x)
        x = _res(x, L.apply_mlp(cfg, p["mlp"], h))
        if want_cache:
            kvs.append(kv)
            ckvs.append(ckv)
    x = L.apply_norm(cfg, params["dec_norm"], x)
    logits = L.unembed(cfg, embed, x)
    if not want_cache:
        return logits, None
    k, v = (torch.stack(t) for t in zip(*kvs))
    xk, xv = (torch.stack(t) for t in zip(*ckvs))
    return logits, ((k, v), (xk, xv))


def _cross_decode(cfg, p, h, xk, xv):
    """One query against the fixed encoder K/V, in f32 as JAX computes it.
    h: [B,1,d]; xk/xv: [B,F,Kv,hd] -> [B,1,d]. On DTensors each rank runs
    it on its batch rows (``sharding.on_local_rows``)."""
    if isinstance(h, DTensor):
        return sh.on_local_rows(
            lambda hl, pl, kl, vl: _cross_decode(cfg, pl, hl, kl, vl), h,
            {k: p[k] for k in ("wq", "wo")}, xk, xv, n_out=1)
    b = h.shape[0]
    kv, g = cfg.n_kv, cfg.n_heads // cfg.n_kv
    q = (h @ p["wq"]).float().reshape(b, kv, g, cfg.hd) * (cfg.hd ** -0.5)
    sc = torch.einsum("bkgd,blkd->bkgl", q, xk.float())
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgl,blkd->bkgd", pr, xv.float())
    return o.reshape(b, 1, cfg.n_heads * cfg.hd).to(h.dtype) @ p["wo"]


def decode_step(cfg, params, tokens, caches, cross_kv, pos):
    """One-token decode. tokens: [B]; caches: stacked (k, v) self caches,
    written in place; cross_kv: stacked (k, v) over the encoder frames.
    -> (logits [B,V], caches)."""
    embed = sh.fsdp_gather(params["embed"])
    x = sh.shard_activation(L.embed_tokens(cfg, embed, tokens[:, None]),
                            "hidden")
    (ck, cv), (xk, xv) = caches, cross_kv
    for li, p in enumerate(params["dec"]):
        p = sh.fsdp_gather(p)
        h = L.apply_norm(cfg, p["norm1"], x)
        a, _, _ = attn.attn_decode(cfg, p["self"], h, ck[li], cv[li], pos)
        x = _res(x, a)
        h = L.apply_norm(cfg, p["norm_x"], x)
        x = _res(x, _cross_decode(cfg, p["cross"], h, xk[li], xv[li]))
        h = L.apply_norm(cfg, p["norm2"], x)
        x = _res(x, L.apply_mlp(cfg, p["mlp"], h))
    x = L.apply_norm(cfg, params["dec_norm"], x)
    return L.unembed(cfg, embed, x)[:, 0], caches


def init_dec_cache(cfg, batch: int, cache_len: int, dtype, device):
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.hd)
    xshape = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv, cfg.hd)

    def zeros(s):
        return torch.zeros(s, dtype=dtype, device=device)

    return (zeros(shape), zeros(shape)), (zeros(xshape), zeros(xshape))
