"""Carry graph state, op batches, reachability indexes and LM params across
the numpy boundary.

Packed words cross as numpy ``uint32`` arrays (the JAX package's dtype)
and live in the port as ``torch.int32`` with the same bits. The
constructors place tensors on the card unless ``device`` names another.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.graph import (GraphState, OpBatch, packed_width,
                                    resolve_device)
from repro_torch.core.partition import ShardedGraphState, shard_state, unshard
from repro_torch.index.labels import ReachIndex
from repro_torch.models.layers import pdict
from repro_torch.models.transformer import layer_slots


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
    """A numpy array (bfloat16 as the ml_dtypes type JAX hands out) as a
    tensor of the same dtype and bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


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
