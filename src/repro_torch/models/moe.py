"""Mixture-of-Experts FFN: top-k token-choice routing, one group a batch
row; the port of ``repro.models.moe``.

Routing is JAX's, decision for decision: per group (batch row) the router's
f32 softmax, the top k experts with ties to the lower index (a stable
descending sort: ``torch.topk`` breaks ties otherwise), the flat (token,
choice) list sorted stably by expert, each entry's rank within its expert,
``keep = rank < cap`` and ``slot = expert * cap + rank``. Capacity is
JAX's: drop-free (``cap = gs * k``) while ``gs * k <= 4096``, else
``round(gs * k / E * capacity_factor)`` with the later entries of a full
expert dropped.

The expert products differ in form, not in function. JAX computes every
expert over a zero-padded [B, E, cap, d] dispatch buffer, which at a
drop-free capacity is E times the routed work (at olmoe-1b-7b's 8 x 512
prefill, 26 TFLOP and an 8.6 GB buffer a layer, against 0.41 TFLOP for
the rows routed). The port runs each expert's three products over its
kept rows only, then combines as JAX does: each kept row's output times
its routing weight cast to the activations' dtype, summed over the
token's choices. On a mesh (and on DTensors) the layer is JAX's own form,
``apply_moe_static``: its shapes do not depend on the routing, so it runs
on fake tensors and shards as JAX's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.layers import _act, dense_init, dtype_of, pdict
from repro_torch.parallel import sharding as sh

DROP_FREE_ROWS = 4096   # a group with gs * k up to this keeps every token


def init_moe(gen, cfg) -> nn.ParameterDict:
    dt = dtype_of(cfg)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    return pdict(router=dense_init(gen, (d, e), torch.float32),
                 wi=dense_init(gen, (e, d, f), dt),
                 wg=dense_init(gen, (e, d, f), dt),
                 wo=dense_init(gen, (e, f, d), dt))


def capacity(cfg, gs: int, capacity_factor: float = 1.25) -> int:
    """Rows each expert keeps in a group of ``gs`` tokens."""
    k = cfg.top_k
    if gs * k <= DROP_FREE_ROWS:
        return gs * k
    return int(max(1, round(gs * k / cfg.n_experts * capacity_factor)))


def route(cfg, router, x, cap: int) -> dict:
    """JAX's ``_dispatch_group`` decisions for every group (batch row) of
    x [B, gs, d], in its sorted order (entries sorted stably by expert):
    ``se`` expert, ``st`` token, ``sw`` f32 weight, ``keep``, ``slot`` (E *
    cap where dropped) and ``order`` (the entry's index t * k + j in the
    unsorted (token, choice) list), each [B, gs * k]; ``top_e`` [B, gs,
    k]; and ``aux`` [B], each group's load-balancing loss."""
    e, k = cfg.n_experts, cfg.top_k
    b, gs, _ = x.shape
    logits = x.float() @ router                                  # [B,gs,E]
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: the k largest, ties to the lower index
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    me = probs.mean(1)                                           # [B,E]
    ce = F.one_hot(top_e[..., 0], e).float().mean(1)
    aux = e * (me * ce).sum(-1)

    flat_e = top_e.reshape(b, gs * k)
    flat_t = torch.arange(gs, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sw = torch.gather(top_p.reshape(b, gs * k), 1, order)
    counts = torch.zeros((b, e), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(gs * k, device=x.device) - torch.gather(starts, 1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + torch.clamp(rank, 0, cap - 1),
                       e * cap)
    return {"se": se, "st": st, "sw": sw, "keep": keep, "slot": slot,
            "order": order, "top_e": top_e, "aux": aux}


def dispatch(cfg, r, x, cap: int):
    """JAX's capacity buffer [B, E, cap, d]: each kept (token, choice) row
    of x at its slot, every other row zero."""
    b, s, d = x.shape
    e = cfg.n_experts
    src = torch.gather(x, 1, r["st"][..., None].expand(-1, -1, d))
    src = torch.where(r["keep"][..., None], src, 0)
    xin = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    xin = xin.scatter(1, r["slot"][..., None].expand(-1, -1, d), src)
    return xin[:, :e * cap].reshape(b, e, cap, d)


def combine(cfg, r, yo, s: int):
    """JAX's combine: yo [B, E * cap, d] -> y [B, S, d], each kept entry's
    expert output times its weight (in the activations' dtype) added to
    its token."""
    b, ec, d = yo.shape
    rows = torch.gather(yo, 1, r["slot"].clamp(0, ec - 1)[..., None]
                        .expand(-1, -1, d))
    rows = rows * r["sw"][..., None].to(yo.dtype)
    tok = torch.where(r["keep"], r["st"], s)
    y = torch.zeros((b, s + 1, d), dtype=yo.dtype, device=yo.device)
    return y.scatter_add(1, tok[..., None].expand(-1, -1, d), rows)[:, :s]


def apply_moe_static(cfg, p, x, *, capacity_factor: float = 1.25):
    """``apply_moe`` in JAX's own form, with shapes that do not depend on
    the routing: the [B, E, cap, d] dispatch buffer, three einsums over
    every expert's capacity and the combine. On DTensors the routing,
    dispatch and combine run on each rank's batch rows (``local_map``,
    the router whole on every rank) and the buffers are pinned by the
    ``moe_dispatch4`` hook, experts over "model" when they divide it."""
    b, s, d = x.shape
    cap = capacity(cfg, s, capacity_factor)
    if not isinstance(x, DTensor):
        r = route(cfg, p["router"], x, cap)
        xin = dispatch(cfg, r, x, cap)
        yo = _experts(cfg, p, xin).reshape(b, -1, d)
        return combine(cfg, r, yo, s), r["aux"].mean() * cfg.router_aux_coef

    mesh = x.device_mesh
    # groups are batch rows: each rank routes its own rows, whole
    rows = [pl if pl == Shard(0) else Replicate()
            for pl in sh.shard_activation(x, "hidden").placements]
    x = x.redistribute(mesh, rows)
    rep = [Replicate()] * mesh.ndim
    router = p["router"].redistribute(mesh, rep)
    keys = ("aux", "st", "sw", "keep", "slot")   # each [B] or [B, S * k]

    def local_route(xl, rl):
        r = route(cfg, rl, xl, cap)
        return (dispatch(cfg, r, xl, cap), *(r[k] for k in keys))

    # each rank's router gradient covers its own rows: a partial sum
    # over the mesh dims that split them
    router_grad = [Partial() if pl == Shard(0) else pl for pl in rows]
    xin, aux, *rest = local_map(
        local_route, out_placements=(rows, *([rows] * 5)),
        in_placements=(rows, rep), in_grad_placements=(rows, router_grad),
        device_mesh=mesh)(x, router)
    # the moe_dispatch4 hook's layout, without its capacity split (taken
    # where the experts do not divide "model"): the einsums flatten
    # [G, C] into one dim, and a split of both is a strided split DTensor
    # cannot multiply
    spec = sh.activation_spec(tuple(xin.shape), "moe_dispatch4")
    spec = sh.P(spec[0], spec[1], None, None)
    xin = sh.constrain(xin, spec)
    yo = sh.constrain(_experts(cfg, p, xin), spec)
    yo = yo.redistribute(mesh, rows).reshape(b, -1, d)

    def local_combine(yl, *rl):
        return combine(cfg, dict(zip(keys[1:], rl)), yl, s)

    y = local_map(local_combine, out_placements=rows,
                  in_placements=(rows, *([rows] * 4)), device_mesh=mesh)(
                      yo, *rest)
    return y, aux.mean() * cfg.router_aux_coef


def _experts(cfg, p, xin):
    h = _act(cfg, torch.einsum("gecd,edf->gecf", xin, p["wg"])) * (
        torch.einsum("gecd,edf->gecf", xin, p["wi"]))
    return torch.einsum("gecf,efd->gecd", h, p["wo"])


def apply_moe(cfg, p, x, *, capacity_factor: float = 1.25):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar). Group = batch row.
    With a mesh set (or on DTensors) this is ``apply_moe_static``."""
    if sh.activation_mesh() is not None or isinstance(x, DTensor):
        return apply_moe_static(cfg, p, x, capacity_factor=capacity_factor)
    b, s, d = x.shape
    k = cfg.top_k
    r = route(cfg, p["router"], x, capacity(cfg, s, capacity_factor))
    # the kept entries of every group, grouped by expert (the host reads
    # the counts to size each expert's products)
    ent = torch.nonzero(r["keep"].reshape(-1)).squeeze(1)
    experts = r["se"].reshape(-1)[ent]
    ent = ent[torch.argsort(experts, stable=True)]
    counts = torch.bincount(experts, minlength=cfg.n_experts).tolist()
    grp = torch.div(ent, s * k, rounding_mode="floor")
    xs = x[grp, r["st"].reshape(-1)[ent]]
    yo = torch.empty_like(xs)
    start = 0
    for j, n in enumerate(counts):
        if n:
            xj = xs[start:start + n]
            h = _act(cfg, xj @ p["wg"][j]) * (xj @ p["wi"][j])
            yo[start:start + n] = h @ p["wo"][j]
            start += n
    # back to (token, choice) order; a dropped choice adds nothing
    contrib = torch.zeros((b * s * k, d), dtype=x.dtype, device=x.device)
    w = r["sw"].reshape(-1)[ent].to(x.dtype)
    contrib[grp * (s * k) + r["order"].reshape(-1)[ent]] = yo * w[:, None]
    y = contrib.view(b, s, k, d).sum(2)
    return y, r["aux"].mean() * cfg.router_aux_coef
