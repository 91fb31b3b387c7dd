"""Carry graph state, op batches, reachability indexes, LM params and LM
train state across the numpy boundary, both ways.

Packed words cross as numpy ``uint32`` arrays (the JAX package's dtype)
and live in the port as ``torch.int32`` with the same bits. bfloat16
crosses as its raw bits: numpy's two-byte void type (what ``np.save``
writes for ml_dtypes' bfloat16, which this package does not need), or
ml_dtypes' bfloat16 where JAX hands that out. The constructors place
tensors on the card unless ``device`` names another.

LM trees: the JAX package stacks the layers of each stack of the block
pattern into one leaf with a leading group axis (``{"stacks": [{str(li):
leaves}]}``, and whisper's encoder and decoder over their layers); the
port keeps one module a layer. ``jax_layout`` maps the one onto the other,
in JAX's leaf order (dict keys sorted), so that trees, gradients, moments
and checkpoints compare and load leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.checkpointer import is_bf16_bits, to_host
from repro_torch.core.graph import (GraphState, OpBatch, packed_width,
                                    resolve_device)
from repro_torch.core.partition import ShardedGraphState, shard_state, unshard
from repro_torch.index.labels import ReachIndex
from repro_torch.models.layers import pdict
from repro_torch.models.transformer import _pattern, layer_slots
from repro_torch.optim.adamw import AdamWState, named_leaves


def _words_in(x, shape, name) -> torch.Tensor:
    a = np.ascontiguousarray(x)
    if a.dtype not in (np.uint32, np.int32) or a.shape != shape:
        raise ValueError(f"{name}: want uint32{list(shape)}, got "
                         f"{a.dtype}{list(a.shape)}")
    return torch.from_numpy(a.view(np.int32).copy())


def state_from_numpy(vkey, valive, vver, ecnt, adj_packed_u32,
                     adj_in_packed_u32, device=None) -> GraphState:
    """A GraphState from the six numpy arrays of a JAX state (or of
    ``state_to_numpy``)."""
    dev = resolve_device(device)
    v = len(vkey)
    shape = (v, packed_width(v))
    fields = (torch.from_numpy(np.array(vkey, np.int32)),
              torch.from_numpy(np.array(valive, np.bool_)),
              torch.from_numpy(np.array(vver, np.int32)),
              torch.from_numpy(np.array(ecnt, np.int32)),
              _words_in(adj_packed_u32, shape, "adj_packed"),
              _words_in(adj_in_packed_u32, shape, "adj_in_packed"))
    for f in fields[:4]:
        if f.shape != (v,):
            raise ValueError(f"slot arrays must all have length {v}")
    return GraphState(*(f.to(dev) for f in fields))


def sharded_state_from_numpy(mesh, vkey, valive, vver, ecnt, adj_packed_u32,
                             adj_in_packed_u32):
    """A ``core.partition.ShardedGraphState`` on ``mesh`` (a
    ``core.distributed.GraphMesh``) from the six numpy arrays of a JAX
    state, so both packages start from the same state."""
    return shard_state(mesh, state_from_numpy(
        vkey, valive, vver, ecnt, adj_packed_u32, adj_in_packed_u32,
        device=mesh.device))


def state_to_numpy(state) -> tuple:
    """(vkey, valive, vver, ecnt, adj_packed, adj_in_packed) as numpy; the
    two word matrices as uint32 views. A sharded state is gathered."""
    if isinstance(state, ShardedGraphState):
        state = unshard(state)
    out = [t.cpu().numpy() for t in state]
    out[4] = out[4].view(np.uint32)
    out[5] = out[5].view(np.uint32)
    return tuple(out)


def op_batch_from_numpy(opcode, key1, key2, expect, device=None) -> OpBatch:
    """An OpBatch from four int32 arrays of equal shape (a leading T axis
    is allowed, as ``interleaved_getpath`` takes)."""
    dev = resolve_device(device)
    cols = [np.asarray(c, np.int32) for c in (opcode, key1, key2, expect)]
    if len({c.shape for c in cols}) != 1:
        raise ValueError("op batch columns must have one shape")
    return OpBatch(*(torch.from_numpy(c.copy()).to(dev) for c in cols))


def index_from_numpy(landmarks, out_label_u32, in_label_u32, fwd, bwd, alive,
                     versions, complete: bool, requested: int | None,
                     device=None):
    """A ``repro_torch.index.ReachIndex`` from the arrays of a JAX
    ``ReachIndex`` as numpy (the label words as uint32 or int32) plus its
    host metadata ``complete`` and ``requested``."""
    dev = resolve_device(device)
    lm = np.array(landmarks, np.int32).reshape(-1)
    al = np.array(alive, np.bool_)
    shape = (al.shape[0], packed_width(lm.shape[0]))
    fields = (torch.from_numpy(lm),
              _words_in(out_label_u32, shape, "out_label"),
              _words_in(in_label_u32, shape, "in_label"),
              torch.from_numpy(np.array(fwd, np.bool_)),
              torch.from_numpy(np.array(bwd, np.bool_)),
              torch.from_numpy(al),
              torch.from_numpy(np.array(versions, np.int32)))
    return ReachIndex(*(f.to(dev) for f in fields), complete=bool(complete),
                      requested=None if requested is None else int(requested))


def _leaf(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 as ``is_bf16_bits`` knows it) as a tensor of
    the same dtype and bits."""
    a = np.array(a, order="C")        # a copy, 0-d kept
    if is_bf16_bits(a):
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_numpy(cfg, tree, device=None):
    """The port's LM params (``models.model.Model.init``'s structure) from
    a JAX ``Model.init`` tree as numpy arrays: ``{"embed": ..., "trunk":
    {"stacks": [{str(li): leaves with a leading group axis}],
    "final_norm": ...}}``. Group g of stack s, position li becomes layer
    module (s, g, li); every tensor lands on ``device``."""
    dev = resolve_device(device)

    def group(d, g=None):
        return pdict(**{k: _leaf(v if g is None else v[g], dev)
                        for k, v in d.items()})

    stacks = tree["trunk"]["stacks"]
    layers = nn.ModuleList(
        nn.ModuleDict({name: group(sub, g)
                       for name, sub in stacks[si][str(li)].items()})
        for si, g, li, _ in layer_slots(cfg))
    trunk = nn.ModuleDict({"layers": layers,
                           "final_norm": group(tree["trunk"]["final_norm"])})
    return nn.ModuleDict({"embed": group(tree["embed"]), "trunk": trunk})


def encdec_params_from_numpy(cfg, tree, device=None):
    """The port's encoder-decoder params (``models.encdec.init_encdec``'s
    structure) from a JAX ``EncDecModel.init`` tree as numpy arrays:
    ``{"embed", "enc", "enc_norm", "dec", "dec_norm"}`` with ``enc`` and
    ``dec`` stacked over layers; layer i of each becomes module i."""
    dev = resolve_device(device)

    def group(d, i=None):
        return pdict(**{k: _leaf(v if i is None else v[i], dev)
                        for k, v in d.items()})

    def stack(sub, n):
        return nn.ModuleList(
            nn.ModuleDict({name: group(leaves, i)
                           for name, leaves in sub.items()})
            for i in range(n))

    return nn.ModuleDict({
        "embed": group(tree["embed"]),
        "enc": stack(tree["enc"], cfg.enc_layers),
        "enc_norm": group(tree["enc_norm"]),
        "dec": stack(tree["dec"], cfg.n_layers),
        "dec_norm": group(tree["dec_norm"])})


# ----------------------------------------------------------------------------
# the JAX layout of LM trees
# ----------------------------------------------------------------------------
def _names(m, prefix=""):
    """The nested dicts (keys sorted) and lists of a params module, holding
    each parameter's ``named_parameters`` name."""
    if isinstance(m, nn.ParameterDict):
        return {k: prefix + k for k in sorted(m.keys())}
    if isinstance(m, nn.ModuleList):
        return [_names(c, f"{prefix}{i}.") for i, c in enumerate(m)]
    return {k: _names(m[k], f"{prefix}{k}.") for k in sorted(m.keys())}


def _stacked(trees):
    """Trees of one structure -> that structure with the tuple of their
    names at each leaf (one leaf stacked over them in JAX)."""
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return tuple(trees)


def jax_layout(cfg, params):
    """The JAX package's tree of the port's parameter names: a leaf the JAX
    package stacks over a stack's groups (or whisper's layers) is the tuple
    of the port's names, one a group."""
    t = _names(params)
    if cfg.family == "encdec":
        return {k: _stacked(v) if k in ("enc", "dec") else v
                for k, v in t.items()}
    trunk = t["trunk"]
    stacks = [{} for _ in _pattern(cfg)]
    for (si, _, li, _), lt in zip(layer_slots(cfg), trunk.pop("layers"),
                                  strict=True):
        stacks[si].setdefault(str(li), []).append(lt)
    trunk["stacks"] = [{li: _stacked(g[li]) for li in sorted(g)}
                       for g in stacks]
    t["trunk"] = dict(sorted(trunk.items()))
    return t


def _map(layout, fn):
    if isinstance(layout, dict):
        return {k: _map(v, fn) for k, v in layout.items()}
    if isinstance(layout, list):
        return [_map(v, fn) for v in layout]
    return fn(layout)


def to_jax_tree(cfg, params, leaves=None, stack=torch.stack,
                leaf=lambda t: t):
    """The port's params, or ``leaves`` keyed by their names (gradients,
    moments), in the JAX package's tree: each stacked leaf is ``stack`` of
    its layers' tensors, each other ``leaf`` of its tensor."""
    src = named_leaves(params) if leaves is None else leaves
    return _map(jax_layout(cfg, params),
                lambda n: stack([src[x] for x in n]) if isinstance(n, tuple)
                else leaf(src[n]))


def from_jax_tree(cfg, params, tree) -> dict:
    """A tree in the JAX package's layout -> {parameter name: leaf}, a
    stacked leaf split into its groups' views."""
    out = {}

    def put(layout, t):
        if isinstance(layout, dict):
            for k, v in layout.items():
                put(v, t[k])
        elif isinstance(layout, list):
            for v, x in zip(layout, t, strict=True):
                put(v, x)
        elif isinstance(layout, tuple):
            for g, name in enumerate(layout):
                out[name] = t[g]
        else:
            out[layout] = t

    put(jax_layout(cfg, params), tree)
    return out


def _np_stack(ts):
    return np.stack([to_host(t) for t in ts])


def lm_params_to_numpy(cfg, params, leaves=None):
    """The inverse of ``lm_params_from_numpy`` (and of
    ``encdec_params_from_numpy``): the JAX package's tree of numpy arrays,
    bfloat16 as raw bits. With ``leaves`` (a dict keyed by the params'
    names, such as the gradients a train step takes), those in their
    place."""
    return to_jax_tree(cfg, params, leaves, stack=_np_stack, leaf=to_host)


def adamw_state_to_numpy(cfg, params, state: AdamWState) -> AdamWState:
    """An ``optim.adamw.AdamWState`` as the JAX package's: the step an
    int32 scalar, the moments in the params' JAX tree, numpy throughout."""
    return AdamWState(step=to_host(state.step),
                      mu=lm_params_to_numpy(cfg, params, state.mu),
                      nu=lm_params_to_numpy(cfg, params, state.nu))


def adamw_state_from_numpy(cfg, params, state, device=None) -> AdamWState:
    """A JAX ``AdamWState`` (numpy leaves, or any (step, mu, nu)) ->
    the port's, its moments keyed by the params' names, on ``device``."""
    dev = resolve_device(device)

    def moments(tree):
        return {n: _leaf(a, dev)
                for n, a in from_jax_tree(cfg, params, tree).items()}

    step, mu, nu = state
    return AdamWState(step=_leaf(np.asarray(step, np.int32), dev),
                      mu=moments(mu), nu=moments(nu))
