"""Unified model API: ``build_model(config)`` -> ``Model`` (decoder-only:
dense, moe, ssm, hybrid, vlm backbone) or ``EncDecModel`` (whisper) with
init, forward, loss, prefill and decode; the port of
``repro.models.model``.

The serving steps, as ``runtime.serve_loop.serve`` calls them:
  prefill:  prefill(params, batch) -> (last logits [B,V], caches)
  decode:   decode_step(params, caches, tokens, pos) -> (logits, caches)

``params`` is the ``nn.ModuleDict`` that ``init`` returns (or that
``convert.lm_params_from_numpy`` / ``encdec_params_from_numpy`` builds
from a JAX tree); it lives on the device of the generator that drew it.
``loss_and_metrics`` is what training differentiates
(``launch.steps.make_train_step`` takes its gradients with autograd;
``remat=True`` recomputes each group of the block pattern in the backward
pass, as JAX's ``jax.checkpoint`` does). There is no activation-sharding
hook: without a mesh JAX's is a no-op, and the LM half of ``parallel/`` is
ROADMAP.md queue A12 (iv).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def cross_entropy(logits, targets, mask=None):
    """logits: [B,S,V]; targets: [B,S] int; mask: [B,S] or None -> mean
    negative log-likelihood in f32, over the positions ``mask`` keeps (the
    mean over at least one position: an all-zero mask gives 0)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.take_along_dim(lf, targets.long()[..., None], dim=-1)[..., 0]
    ll = tgt - lse
    if mask is None:
        return -ll.mean()
    m = mask.float()
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def params_device(params) -> torch.device:
    return next(params.parameters()).device


class Model:
    """Decoder-only LM families (dense / moe / ssm / hybrid / vlm
    backbone)."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None) -> nn.ModuleDict:
        """Random params drawn from ``generator`` on its device; without
        one, a generator seeded 0 on the card."""
        if generator is None:
            generator = torch.Generator(resolve_device(None)).manual_seed(0)
        return nn.ModuleDict({"embed": L.init_embed(generator, self.cfg),
                              "trunk": T.init_trunk(generator, self.cfg)})

    # -- forward --------------------------------------------------------------
    def _embed_inputs(self, params, batch):
        cfg = self.cfg
        x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
        if cfg.n_vis_tokens:
            vis = batch["vis_embeds"].to(x.dtype)
            x = torch.cat([vis, x], dim=1)
        return x

    def forward(self, params, batch, *, want_cache=False, remat=False,
                last_only=False):
        """batch: {"tokens": int [B,S]} (+ "vis_embeds" [B,n_vis,d] for the
        stub patch embeddings) -> (f32 logits, caches | None, aux)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        x, caches, aux = T.trunk_fwd(cfg, params["trunk"], x, positions,
                                     want_cache=want_cache, remat=remat)
        if cfg.n_vis_tokens:
            x = x[:, cfg.n_vis_tokens:, :]
        if last_only:
            # prefill needs only the final position's logits
            x = x[:, -1:, :]
        logits = L.unembed(cfg, params["embed"], x)
        return logits, caches, aux

    def loss_and_metrics(self, params, batch, *, remat=True):
        logits, _, aux = self.forward(params, batch, remat=remat)
        tok = batch["tokens"]
        loss = cross_entropy(logits[:, :-1], tok[:, 1:]) + aux
        return loss, {"loss": loss, "aux": aux}

    # -- serving --------------------------------------------------------------
    def prefill(self, params, batch):
        logits, caches, _ = self.forward(params, batch, want_cache=True,
                                         last_only=True)
        return logits[:, -1, :], caches

    def decode_step(self, params, caches, tokens, pos):
        """tokens: int [B]; pos: int. -> (logits [B,V], caches), the caches
        written in place."""
        cfg = self.cfg
        x = L.embed_tokens(cfg, params["embed"], tokens[:, None])
        x, caches = T.trunk_decode(cfg, params["trunk"], x, caches, pos)
        logits = L.unembed(cfg, params["embed"], x)[:, 0]
        return logits, caches

    def init_cache(self, batch: int, cache_len: int, device=None):
        return T.init_cache(self.cfg, batch, cache_len, L.dtype_of(self.cfg),
                            resolve_device(device))

    def cache_from_prefill(self, caches, cache_len: int):
        """Prefill caches (length S entries) -> decode caches of
        ``cache_len``: attention entries padded on the length axis, or,
        where a local layer's cache is shorter than the prompt, a ring
        holding the last ``ln`` positions at slot p % ln; ssm/rec entries
        pass through."""
        cfg = self.cfg
        out = []
        for (pat, _), gc in zip(T._pattern(cfg), caches):
            group = {}
            for li, kind in enumerate(pat):
                if kind not in T.ATTN_KINDS:
                    group[str(li)] = gc[str(li)]
                    continue
                k, v = gc[str(li)]
                s = k.shape[2]
                ln = cache_len
                if kind == "local" and cfg.sliding_window:
                    ln = min(cache_len, cfg.sliding_window)
                shape = k.shape[:2] + (ln,) + k.shape[3:]
                zk = torch.zeros(shape, dtype=k.dtype, device=k.device)
                zv = torch.zeros(shape, dtype=v.dtype, device=v.device)
                if ln >= s:
                    zk[:, :, :s] = k
                    zv[:, :, :s] = v
                else:
                    slots = torch.arange(s - ln, s, device=k.device) % ln
                    zk[:, :, slots] = k[:, :, s - ln:]
                    zv[:, :, slots] = v[:, :, s - ln:]
                group[str(li)] = (zk, zv)
            out.append(group)
        return out


class EncDecModel:
    """Whisper-style encoder-decoder; ``frames`` [B, F, d] stand in for the
    stubbed audio frontend. Like JAX's, it has no ``cache_from_prefill``
    and its ``prefill`` needs ``batch["frames"]``, so ``serve()`` and the
    launcher, which pass tokens only, fail on it with ``KeyError:
    'frames'`` in both packages."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg

    def init(self, generator: torch.Generator | None = None) -> nn.ModuleDict:
        """Random params drawn from ``generator`` on its device; without
        one, a generator seeded 0 on the card."""
        if generator is None:
            generator = torch.Generator(resolve_device(None)).manual_seed(0)
        return ed.init_encdec(generator, self.cfg)

    def loss_and_metrics(self, params, batch, *, remat=True):
        """``remat`` is accepted and unused, as in JAX."""
        cfg = self.cfg
        enc = ed.encode(cfg, params, batch["frames"])
        logits, _ = ed.decode_fwd(cfg, params, batch["tokens"], enc,
                                  want_cache=False)
        loss = cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return loss, {"loss": loss, "aux": aux}

    def prefill(self, params, batch):
        cfg = self.cfg
        enc = ed.encode(cfg, params, batch["frames"])
        logits, caches = ed.decode_fwd(cfg, params, batch["tokens"], enc,
                                       want_cache=True)
        return logits[:, -1, :], caches

    def decode_step(self, params, caches, tokens, pos):
        """The self caches written in place; the cross K/V unchanged."""
        self_c, cross_c = caches
        logits, new_self = ed.decode_step(self.cfg, params, tokens, self_c,
                                          cross_c, pos)
        return logits, (new_self, cross_c)

    def init_cache(self, batch: int, cache_len: int, device=None):
        return ed.init_dec_cache(self.cfg, batch, cache_len,
                                 L.dtype_of(self.cfg), resolve_device(device))


def build_model(cfg: ArchConfig) -> Model | EncDecModel:
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    return Model(cfg)
