"""Decoder-only LM trunk: the port of ``repro.models.transformer``.

Layer heterogeneity (gemma2's local/global alternation, Griffin's
rec/rec/attn triples) is a group pattern, as in JAX: ``_pattern(cfg)``
gives [(group pattern, n_groups)] stacks. JAX stacks each position's
params over the groups and scans them; here every layer is its own
module, in one ``nn.ModuleList`` in JAX's layer order (stack s, group g,
position li), and the trunk loops over them. Caches keep JAX's structure,
a list per stack of ``{str(li): (a, b)}`` with each tensor stacked over
the stack's groups, so the two compare directly. A decode step writes
into them in place, as JAX's ``unroll=True`` serving step does: an
attention layer its k/v slot, a state layer its whole [g] entry.

Layer kinds (cfg.family -> pattern, see ``_pattern``):
  "global"     pre-norm GQA attention (full causal) + MLP
  "local"      same with sliding-window mask
  "moe"        attention + MoE FFN
  "ssm"        mamba2 SSD mixer only (no MLP)
  "rec"        RG-LRU temporal block + MLP
Caches per kind: attention -> (k, v) [G,B,L,Kv,hd]; ssm -> (state
[G,B,H,N,hd] f32, conv tail [G,B,K-1,din]); rec -> (h [G,B,d_lru] f32,
conv tail [G,B,K-1,d_lru]).
"""
from __future__ import annotations

import itertools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru
from repro_torch.models import ssm as ssm_mod

# ----------------------------------------------------------------------------
# patterns
# ----------------------------------------------------------------------------
_KIND_ALIASES = {"attn_local": "local", "attn": "global"}
ATTN_KINDS = ("global", "local", "moe")
PORTED_KINDS = ATTN_KINDS + ("ssm", "rec")


def _norm_kind(kind: str) -> str:
    return _KIND_ALIASES.get(kind, kind)


def _pattern(cfg) -> list[tuple[tuple[str, ...], int]]:
    """[(group_pattern, n_groups), ...] covering cfg.n_layers layers."""
    if cfg.family == "ssm":
        return [(("ssm",), cfg.n_layers)]
    if cfg.family == "hybrid":
        pat = tuple(_norm_kind(k) for k in cfg.block_pattern) or ("rec",)
        n_groups, rem = divmod(cfg.n_layers, len(pat))
        out = [(pat, n_groups)] if n_groups else []
        if rem:
            out.append((pat[:rem], 1))
        return out
    if cfg.local_global_period == 2 and cfg.sliding_window:
        if cfg.n_layers % 2:
            raise ValueError("the (local, global) alternation needs an even "
                             f"n_layers, got {cfg.n_layers}")
        return [(("local", "global"), cfg.n_layers // 2)]
    kind = "moe" if cfg.n_experts else "global"
    return [((kind,), cfg.n_layers)]


def _layer_kind_window(cfg, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def layer_slots(cfg):
    """(stack, group, position, kind) of every layer, in module order."""
    return [(si, g, li, kind)
            for si, (pat, n_groups) in enumerate(_pattern(cfg))
            for g in range(n_groups) for li, kind in enumerate(pat)]


# ----------------------------------------------------------------------------
# per-layer init / forward / decode
# ----------------------------------------------------------------------------
def _init_layer(gen, cfg, kind: str) -> nn.ModuleDict:
    dev = gen.device
    p = {"norm1": L.init_norm(cfg, cfg.d_model, dev)}
    if kind in ATTN_KINDS:
        p["attn"] = attn.init_attn(gen, cfg)
        p["norm2"] = L.init_norm(cfg, cfg.d_model, dev)
        if kind == "moe":
            p["moe"] = moe_mod.init_moe(gen, cfg)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff)
        if cfg.sandwich_norm:
            p["post1"] = L.init_norm(cfg, cfg.d_model, dev)
            p["post2"] = L.init_norm(cfg, cfg.d_model, dev)
    elif kind == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg)
    elif kind == "rec":
        p["rec"] = rglru.init_rglru(gen, cfg)
        p["norm2"] = L.init_norm(cfg, cfg.d_model, dev)
        p["mlp"] = L.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff)
    else:
        raise ValueError(kind)
    return nn.ModuleDict(p)


def _ffn(cfg, kind, p, x):
    """The attention kinds' second half: x + FFN(norm2(x)) (+ post2),
    and the MoE aux loss (0.0 for an MLP)."""
    h2 = L.apply_norm(cfg, p["norm2"], x)
    aux = 0.0
    if kind == "moe":
        f, aux = moe_mod.apply_moe(cfg, p["moe"], h2)
    else:
        f = L.apply_mlp(cfg, p["mlp"], h2)
    if cfg.sandwich_norm:
        f = L.apply_norm(cfg, p["post2"], f)
    return x + f, aux


def _layer_fwd(cfg, kind, p, x, positions, *, want_cache: bool):
    """Full-sequence layer. Returns (x', cache_entry | None, aux_loss)."""
    h = L.apply_norm(cfg, p["norm1"], x)
    aux = 0.0
    if kind in ATTN_KINDS:
        a, cache = attn.attn_forward(cfg, p["attn"], h, positions,
                                     window=_layer_kind_window(cfg, kind))
        if cfg.sandwich_norm:
            a = L.apply_norm(cfg, p["post1"], a)
        x, aux = _ffn(cfg, kind, p, x + a)
    elif kind == "ssm":
        y, state, conv = ssm_mod.apply_ssm(cfg, p["ssm"], h)
        x, cache = x + y, (state, conv)
    elif kind == "rec":
        y, hlast, conv = rglru.apply_rglru(cfg, p["rec"], h)
        x = x + y
        x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))
        cache = (hlast, conv)
    else:
        raise ValueError(kind)
    return x, (cache if want_cache else None), aux


def _layer_decode(cfg, kind, p, x, cache, pos):
    """One-token layer step. Returns (x', cache'): an attention layer
    writes its k/v slot into ``cache`` in place; a state layer returns new
    tensors, as JAX's do, and ``trunk_decode`` copies them in."""
    h = L.apply_norm(cfg, p["norm1"], x)
    if kind in ATTN_KINDS:
        ck, cv = cache
        a, ck, cv = attn.attn_decode(cfg, p["attn"], h, ck, cv, pos,
                                     window=_layer_kind_window(cfg, kind))
        if cfg.sandwich_norm:
            a = L.apply_norm(cfg, p["post1"], a)
        x, _ = _ffn(cfg, kind, p, x + a)
        return x, (ck, cv)
    if kind == "ssm":
        state, conv = cache
        y, state, conv = ssm_mod.apply_ssm_decode(cfg, p["ssm"], h, state,
                                                  conv)
        return x + y, (state, conv)
    if kind == "rec":
        hr, conv = cache
        y, hr, conv = rglru.apply_rglru_decode(cfg, p["rec"], h, hr, conv)
        x = x + y
        x = x + L.apply_mlp(cfg, p["mlp"], L.apply_norm(cfg, p["norm2"], x))
        return x, (hr, conv)
    raise ValueError(kind)


# ----------------------------------------------------------------------------
# trunk init
# ----------------------------------------------------------------------------
def init_trunk(gen, cfg) -> nn.ModuleDict:
    """{"layers": ModuleList in (stack, group, position) order,
    "final_norm": ...}."""
    layers = nn.ModuleList(_init_layer(gen, cfg, kind)
                           for _, _, _, kind in layer_slots(cfg))
    return nn.ModuleDict({"layers": layers,
                          "final_norm": L.init_norm(cfg, cfg.d_model,
                                                    gen.device)})


def _walk(cfg, params):
    """(stack, group, position, kind, layer params) in module order."""
    return [(*slot, p) for slot, p in zip(layer_slots(cfg),
                                          params["layers"], strict=True)]


# ----------------------------------------------------------------------------
# trunk forward (prefill / training forward)
# ----------------------------------------------------------------------------
def trunk_fwd(cfg, params, x, positions, *, want_cache: bool,
              remat: bool = False):
    """x: [B,S,d] -> (x', caches per stack (stacked over groups) | None,
    aux).

    ``remat=True`` recomputes each group of the block pattern in the
    backward pass: only a group's input is saved, as JAX's
    ``jax.checkpoint(..., nothing_saveable)`` of each scanned group saves
    only the scan carry."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    per = [{} for _ in _pattern(cfg)]      # stack -> str(li) -> [entries]
    for (si, _), members in itertools.groupby(_walk(cfg, params),
                                              key=lambda e: e[:2]):
        def group_fwd(x, aux, members=tuple(members)):
            caches = []
            for _, _, li, kind, p in members:
                x, cache, a = _layer_fwd(cfg, kind, p, x, positions,
                                         want_cache=want_cache)
                aux = aux + a
                caches.append((li, cache))
            return x, aux, caches

        if remat:
            x, aux_total, caches = checkpoint(group_fwd, x, aux_total,
                                              use_reentrant=False)
        else:
            x, aux_total, caches = group_fwd(x, aux_total)
        if want_cache:
            for li, cache in caches:
                per[si].setdefault(str(li), []).append(cache)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if not want_cache:
        return x, None, aux_total
    caches = [{li: (torch.stack([a for a, _ in es]),
                    torch.stack([b for _, b in es]))
               for li, es in group.items()} for group in per]
    return x, caches, aux_total


# ----------------------------------------------------------------------------
# trunk decode (one token)
# ----------------------------------------------------------------------------
def trunk_decode(cfg, params, x, caches, pos):
    """x: [B,1,d]; caches as returned by init_cache/prefill -> (x',
    caches), the caches written in place (group g of a stack reads and
    writes its [g] view)."""
    for si, g, li, kind, p in _walk(cfg, params):
        ca, cb = caches[si][str(li)]
        x, (na, nb) = _layer_decode(cfg, kind, p, x, (ca[g], cb[g]), pos)
        if kind not in ATTN_KINDS:
            ca[g].copy_(na)
            cb[g].copy_(nb)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return x, caches


# ----------------------------------------------------------------------------
# cache construction
# ----------------------------------------------------------------------------
def init_cache(cfg, batch: int, cache_len: int, dtype, device):
    """Zeroed decode caches matching trunk_decode's expectations."""
    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    caches = []
    for (pat, n_groups) in _pattern(cfg):
        group = {}
        for li, kind in enumerate(pat):
            if kind in ATTN_KINDS:
                ln = cache_len
                if kind == "local" and cfg.sliding_window:
                    ln = min(cache_len, _window_cache_len(cfg, cache_len))
                shape = (n_groups, batch, ln, cfg.n_kv, cfg.hd)
                group[str(li)] = (zeros(shape), zeros(shape))
            elif kind == "ssm":
                din, nh, hd, n = ssm_mod._dims(cfg)
                group[str(li)] = (
                    zeros((n_groups, batch, nh, n, hd), torch.float32),
                    zeros((n_groups, batch, cfg.ssm_conv - 1, din)))
            elif kind == "rec":
                group[str(li)] = (
                    zeros((n_groups, batch, cfg.d_lru), torch.float32),
                    zeros((n_groups, batch, cfg.ssm_conv - 1, cfg.d_lru)))
            else:
                raise ValueError(kind)
        caches.append(group)
    return caches


def _window_cache_len(cfg, cache_len: int) -> int:
    # local-attention layers never need more than the window
    return min(cache_len, cfg.sliding_window)
