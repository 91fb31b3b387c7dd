"""Shared building blocks: norms, MLPs, embeddings, rotary, init helpers;
the port of ``repro.models.layers``.

Parameters live in ``nn.ParameterDict``s keyed as the JAX package's param
dicts are (``p["wq"]``, ``"bq" in p``), so a reader finds each leaf where
JAX keeps it, and ``convert.lm_params_from_numpy`` fills them from a JAX
tree. ``init_*`` draws from an explicit ``torch.Generator`` on the
generator's device; the numbers differ from ``jax.random``'s, the
distributions do not. No parameter asks for a gradient at init: serving
needs none, and the train step (``launch.steps.make_train_step``) turns
gradients on for the params it is given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdict(**tensors) -> nn.ParameterDict:
    """A ParameterDict of frozen parameters (no autograd)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


# ----------------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------------
def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen, shape, dtype, scale: float | None = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    return (_normal(gen, shape) * s).to(dtype)


def embed_init(gen, shape, dtype):
    return (_normal(gen, shape) * 0.02).to(dtype)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------
def init_norm(cfg, dim: int, device) -> nn.ParameterDict:
    if not cfg.parametric_norm:
        return pdict()
    return pdict(scale=torch.ones((dim,), dtype=torch.float32, device=device))


def apply_norm(cfg, params, x):
    """RMSNorm (or mean-subtracted LayerNorm without bias) in f32, cast
    back to ``x``'s dtype; a non-parametric norm has no scale."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + cfg.norm_eps)
    if cfg.parametric_norm and len(params):
        xf = xf * params["scale"]
    return xf.to(x.dtype)


# ----------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ----------------------------------------------------------------------------
def init_mlp(gen, cfg, d_in: int, d_ff: int) -> nn.ParameterDict:
    dt = dtype_of(cfg)
    return pdict(wi=dense_init(gen, (d_in, d_ff), dt),
                 wg=dense_init(gen, (d_in, d_ff), dt),
                 wo=dense_init(gen, (d_ff, d_in), dt))


def _act(cfg, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.mlp_act == "silu" else F.gelu(x,
                                                          approximate="tanh")


def apply_mlp(cfg, params, x):
    h = _act(cfg, x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wo"]


# ----------------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------------
def rope_freqs(cfg, hd: int, device=None):
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                  device=device), exps)


def apply_rope(cfg, x, positions):
    """x: [..., S, H, hd]; positions: int tensor broadcastable to [..., S].
    Rotates the split halves (not interleaved pairs) in f32."""
    hd = x.shape[-1]
    inv = rope_freqs(cfg, hd, x.device)                   # [hd/2]
    ang = positions[..., None].float() * inv              # [..., S, hd/2]
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def sinusoidal_positions(length: int, dim: int, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    inv = 10000.0 ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=device) / dim)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------------------
# embeddings / unembedding
# ----------------------------------------------------------------------------
def init_embed(gen, cfg) -> nn.ParameterDict:
    dt = dtype_of(cfg)
    p = {"tok": embed_init(gen, (cfg.vocab, cfg.d_model), dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    return pdict(**p)


def embed_tokens(cfg, params, tokens):
    return params["tok"][tokens.long()]


def unembed(cfg, params, x):
    """Logits in f32: the product in the model dtype, then the cast, then
    the final softcap."""
    if cfg.tie_embeddings:
        logits = x @ params["tok"].T
    else:
        logits = x @ params["unembed"]
    return softcap(logits.float(), cfg.final_softcap)
