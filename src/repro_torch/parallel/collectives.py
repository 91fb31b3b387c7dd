"""Collectives: the port of ``repro.parallel.collectives``. The graph
engines' single-controller collectives, and ``psum_hierarchical`` over the
ranks of a ``DeviceMesh``.

JAX runs these inside ``shard_map`` on one value per device. Here a
collective is a plain function over the list of per-shard tensors (one
entry per shard, in shard order) and returns ONE tensor on ``device``
(default: the first shard's), the value every shard would hold. Parts on
another device are copied there with ``.to``; on a mesh whose shards
share one card nothing moves. ``None`` in a part list stands for a shard
whose contribution is the operation's identity (a shard that owns none
of the rows asked about).
"""
from __future__ import annotations

import torch


def _on(parts, device):
    live = [p for p in parts if p is not None]
    if not live:
        raise ValueError("a collective needs at least one part")
    dev = live[0].device if device is None else torch.device(device)
    return [p if p.device == dev else p.to(dev) for p in live], dev


def all_gather(parts, device=None, tiled: bool = False) -> torch.Tensor:
    """Stack the parts along a new leading shard axis ([S, ...]), or
    concatenate them along axis 0 with ``tiled`` (the rows of a
    row-sharded array, in shard order)."""
    on, _ = _on(parts, device)
    return torch.cat(on) if tiled else torch.stack(on)


def or_fold(parts, device=None) -> torch.Tensor:
    """Bitwise OR of packed int32 word parts: one ``all_gather`` and an OR
    fold over the shard axis (the packed frontier exchange)."""
    from repro_torch.core.graph import or_reduce

    return or_reduce(all_gather(parts, device), 0)


def psum(parts, device=None) -> torch.Tensor:
    """Elementwise sum of the parts."""
    on, _ = _on(parts, device)
    out = on[0].clone()
    for p in on[1:]:
        out += p
    return out


def _fold(fn, parts, device):
    on, _ = _on(parts, device)
    out = on[0]
    for p in on[1:]:
        out = fn(out, p)
    return out


def pmin(parts, device=None) -> torch.Tensor:
    """Elementwise minimum of the parts."""
    return _fold(torch.minimum, parts, device)


def pmax(parts, device=None) -> torch.Tensor:
    """Elementwise maximum of the parts."""
    return _fold(torch.maximum, parts, device)


def all_reduce_or(parts, device=None) -> torch.Tensor:
    """Boolean OR all-reduce (the frontier combine of the distributed
    BFS): the int32 sum of the parts, > 0."""
    return psum([None if p is None else p.to(torch.int32) for p in parts],
                device) > 0


def psum_hierarchical(x: torch.Tensor, *, mesh, fast_axes,
                      slow_axes=()) -> torch.Tensor:
    """Sum this process's ``x`` over the named axes of a ``DeviceMesh``:
    the fast (intra-pod) axes first, then the slow (cross-pod) ones, one
    all-reduce per axis over ``mesh.get_group(axis)``. Unlike the list
    collectives above, this is the multi-process form (JAX's runs inside
    ``shard_map``): every rank of the mesh calls it with its own ``x``
    and gets the sum."""
    import torch.distributed._functional_collectives as fc

    for a in tuple(fast_axes) + tuple(slow_axes):
        x = fc.all_reduce(x, "sum", mesh.get_group(a))
    return x
