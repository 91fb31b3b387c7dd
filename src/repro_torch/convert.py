"""Carry graph state, op batches and reachability indexes across the numpy
boundary.

Packed words cross as numpy ``uint32`` arrays (the JAX package's dtype)
and live in the port as ``torch.int32`` with the same bits. The
constructors place tensors on the card unless ``device`` names another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import (GraphState, OpBatch, packed_width,
                                    resolve_device)
from repro_torch.core.partition import ShardedGraphState, shard_state, unshard
from repro_torch.index.labels import ReachIndex


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
