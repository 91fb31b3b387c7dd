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
pass, as JAX's ``jax.checkpoint`` does).

On a mesh (``parallel.sharding.set_activation_mesh``) the params, batch
and caches are DTensors and the same code runs: the activation hooks pin
the layouts at JAX's sites (the embedded inputs and the logits here, each
group's input in the trunk, q and k/v in attention, the MoE dispatch
buffers), each layer's params are gathered over the data axes where they
are used (``fsdp_gather``), and the cross entropy reduces a vocab split
over "model" without gathering the logits. ``init_abstract``,
``abstract_cache`` and ``input_specs`` give the dry run
(``launch.dryrun``) its fake params, caches and inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig, shape_for
from repro_torch.core.graph import resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as sh


def cross_entropy(logits, targets, mask=None):
    """logits: [B,S,V]; targets: [B,S] int; mask: [B,S] or None -> mean
    negative log-likelihood in f32, over the positions ``mask`` keeps (the
    mean over at least one position: an all-zero mask gives 0)."""
    if isinstance(logits, DTensor):
        ll = _log_likelihood_sharded(logits, targets)
    else:
        ll = _log_likelihood(logits, targets)
    if mask is None:
        return -ll.mean()
    m = mask.float()
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def _log_likelihood(logits, targets):
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.take_along_dim(lf, targets.long()[..., None], dim=-1)[..., 0]
    return tgt - lse


class _VocabParallelLL(torch.autograd.Function):
    """Per-position log-likelihood of logits whose vocab is split over a
    mesh dim (rank r holds columns [r * Vl, (r + 1) * Vl)): the max, the
    sum of exponentials and the target's logit are reduced over that dim's
    group, so no rank holds the whole [B, S, V]. The backward needs no
    collective: d ll / d logits = onehot - exp(logits - lse) on the local
    columns, as ``logsumexp``'s backward forms it."""

    @staticmethod
    def forward(ctx, lf, targets, v0, group):
        m = fc.all_reduce(lf.amax(-1), "max", group)
        e = torch.exp(lf - m[..., None])
        se = fc.all_reduce(e.sum(-1), "sum", group)
        local = targets.long() - v0
        inside = (local >= 0) & (local < lf.shape[-1])
        t = torch.take_along_dim(lf, local.clamp(0, lf.shape[-1] - 1)[..., None],
                                 dim=-1)[..., 0]
        tgt = fc.all_reduce(torch.where(inside, t, 0.0), "sum", group)
        lse = torch.log(se) + m
        ctx.save_for_backward(lf, lse, local, inside)
        return tgt - lse

    @staticmethod
    def backward(ctx, g):
        lf, lse, local, inside = ctx.saved_tensors
        grad = -g[..., None] * (lf - lse[..., None]).exp()
        hit = torch.zeros_like(grad).scatter_(
            -1, local.clamp(0, grad.shape[-1] - 1)[..., None],
            torch.where(inside, g, 0.0)[..., None])
        return hit + grad, None, None, None


def _log_likelihood_sharded(logits, targets):
    """``_log_likelihood`` of DTensor logits: on each rank's blocks
    (``local_map``), the vocab reduced over "model" where the ``logits``
    hook split it there; the result has the logits' layout without the
    vocab dim."""
    mesh = logits.device_mesh
    lp = list(logits.placements)
    tp = [Replicate() if p == Shard(2) else p for p in lp]
    targets = targets.redistribute(mesh, tp)
    # a vocab split over a mesh dim of one rank is the whole vocab
    md = [i for i, p in enumerate(lp)
          if p == Shard(logits.ndim - 1) and mesh.size(i) > 1]

    def local(lf, tl):
        if not md:
            return _log_likelihood(lf, tl)
        (i,) = md
        v0 = mesh.get_local_rank(i) * lf.shape[-1]
        return _VocabParallelLL.apply(lf.float(), tl, v0, (mesh, i))

    return local_map(local, out_placements=tp,
                     in_placements=(lp, tp), device_mesh=mesh)(
                         logits, targets)


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

    def init_abstract(self, mode=None):
        return init_abstract(self, mode)

    # -- forward --------------------------------------------------------------
    def _embed_inputs(self, params, batch):
        cfg = self.cfg
        # on a mesh the vocab-split lookup is a masked partial sum: reduce
        # it (the "hidden" pin) before it meets the patch embeddings
        x = sh.shard_activation(L.embed_tokens(
            cfg, sh.fsdp_gather(params["embed"]), batch["tokens"]), "hidden")
        if cfg.n_vis_tokens:
            vis = batch["vis_embeds"].to(x.dtype)
            x = torch.cat([vis, x], dim=1)
        return sh.shard_activation(x, "hidden")

    def forward(self, params, batch, *, want_cache=False, remat=False,
                last_only=False):
        """batch: {"tokens": int [B,S]} (+ "vis_embeds" [B,n_vis,d] for the
        stub patch embeddings) -> (f32 logits, caches | None, aux)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        s = x.shape[1]
        positions = sh.replicate_like(
            torch.arange(s, dtype=torch.int32, device=x.device), x)
        x, caches, aux = T.trunk_fwd(cfg, params["trunk"], x, positions,
                                     want_cache=want_cache, remat=remat)
        if cfg.n_vis_tokens:
            x = x[:, cfg.n_vis_tokens:, :]
        if last_only:
            # prefill needs only the final position's logits
            x = x[:, -1:, :]
        logits = L.unembed(cfg, sh.fsdp_gather(params["embed"]), x)
        logits = sh.shard_activation(logits, "logits")
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
        embed = sh.fsdp_gather(params["embed"])
        x = sh.shard_activation(L.embed_tokens(cfg, embed, tokens[:, None]),
                                "hidden")
        x, caches = T.trunk_decode(cfg, params["trunk"], x, caches, pos)
        logits = sh.shard_activation(L.unembed(cfg, embed, x)[:, 0],
                                     "logits")
        return logits, caches

    def init_cache(self, batch: int, cache_len: int, device=None):
        return T.init_cache(self.cfg, batch, cache_len, L.dtype_of(self.cfg),
                            resolve_device(device))

    def abstract_cache(self, batch: int, cache_len: int, mode=None):
        return abstract_cache(self, batch, cache_len, mode)

    def input_specs(self, shape_name: str) -> dict:
        """Shape/dtype stand-ins of a cell's inputs: "tokens" (+
        "vis_embeds" for the stub patch embeddings) of a train or prefill
        shape; "tokens" [B] and "pos" of a decode shape."""
        cfg = self.cfg
        b, s, kind = _shape(shape_name)
        if kind in ("train", "prefill"):
            specs = {"tokens": InputSpec((b, s - cfg.n_vis_tokens),
                                         torch.int32)}
            if cfg.n_vis_tokens:
                specs["vis_embeds"] = InputSpec(
                    (b, cfg.n_vis_tokens, cfg.d_model), L.dtype_of(cfg))
            return specs
        return {"tokens": InputSpec((b,), torch.int32),
                "pos": InputSpec((), torch.int32)}

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

    def init_abstract(self, mode=None):
        return init_abstract(self, mode)

    def abstract_cache(self, batch: int, cache_len: int, mode=None):
        return abstract_cache(self, batch, cache_len, mode)

    def input_specs(self, shape_name: str) -> dict:
        """"tokens" and the stub frontend's "frames" of a train or prefill
        shape; "tokens" [B] and "pos" of a decode shape."""
        cfg = self.cfg
        b, s, kind = _shape(shape_name)
        if kind in ("train", "prefill"):
            return {"tokens": InputSpec((b, s), torch.int32),
                    "frames": InputSpec((b, cfg.enc_frames, cfg.d_model),
                                        L.dtype_of(cfg))}
        return {"tokens": InputSpec((b,), torch.int32),
                "pos": InputSpec((), torch.int32)}


class InputSpec(NamedTuple):
    """A shape and dtype standing in for an input (JAX's
    ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype


def _shape(shape_name: str) -> tuple:
    sh_ = shape_for(shape_name)
    return sh_["global_batch"], sh_["seq_len"], sh_["kind"]


def _fake_mode(mode):
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode() if mode is None else mode


def init_abstract(model, mode=None):
    """The model's params as fake tensors of ``mode`` (a fresh
    ``FakeTensorMode`` by default): every shape and dtype of ``init``, no
    memory anywhere. Later work on them enters that mode
    (``fake_mode_of``)."""
    with _fake_mode(mode):
        return model.init(torch.Generator("cpu").manual_seed(0))


def abstract_cache(model, batch: int, cache_len: int, mode=None):
    """``init_cache``'s structure as fake tensors of ``mode`` on the
    CPU."""
    with _fake_mode(mode):
        return model.init_cache(batch, cache_len, device="cpu")


def fake_mode_of(tree):
    """The ``FakeTensorMode`` of a tree's fake tensors (None if none)."""
    from torch._guards import detect_fake_mode
    from torch.utils import _pytree as pytree

    leaves = (list(tree.parameters()) if isinstance(tree, nn.Module)
              else pytree.tree_leaves(tree))
    return detect_fake_mode([t for t in leaves
                             if isinstance(t, torch.Tensor)])


def build_model(cfg: ArchConfig) -> Model | EncDecModel:
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    return Model(cfg)
