"""Wrapper of the device path walk (path_walk/kernel.cu).

``path_walk`` walks every query's parent chain from its destination back
to its source and returns int32[Q, 2 + cap] on ``parent``'s device: a
row's found flag, its path's length and the keys of its first ``cap``
slots in source-to-destination order, padded with -1 (the contract of
``ref.py``). On a CUDA ``parent`` it makes one launch of the kernel, which
reads and writes only device memory, and raises on an operand elsewhere;
on a CPU ``parent`` it runs the plain version (the host walk); on
anything else it raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.path_walk.ref import CAP, path_walk_ref

launches = 0


def _launch(parent, found, src_slot, dst_slot, vkey, cap):
    global launches
    dev = parent.device
    q, v = parent.shape
    _build.check_tensor(parent, "parent", torch.int32, (q, v), dev)
    _build.check_tensor(found, "found", torch.bool, (q,), dev)
    _build.check_tensor(src_slot, "src_slot", torch.int32, (q,), dev)
    _build.check_tensor(dst_slot, "dst_slot", torch.int32, (q,), dev)
    _build.check_tensor(vkey, "vkey", torch.int32, (v,), dev)
    out = torch.empty((q, 2 + cap), dtype=torch.int32, device=dev)
    out.fill_(-1)
    _build.launch("path_walk", "path_walk_launch", dev, parent, found,
                  src_slot, dst_slot, vkey, out, q, v, cap)
    launches += 1
    return out


def path_walk(parent, found, src_slot, dst_slot, vkey, cap: int = CAP):
    """int32[Q, 2 + cap]: per query its found flag, its path's length and
    its first ``cap`` path keys from the source, -1 padded."""
    if parent.is_cuda:
        return _launch(parent, found, src_slot, dst_slot, vkey, cap)
    if parent.device.type == "cpu":
        return path_walk_ref(parent, found, src_slot, dst_slot, vkey, cap)
    raise ValueError(f"no path walk kernel for device {parent.device}")
