"""Wrapper of the device serial correction pass (serial_pass/kernel.cu).

``serial_pass`` applies the ``mask``-selected lanes of a batch to a graph
state's six arrays in place, in lane order, and writes their result codes
into ``res`` (the contract of ``ref.py``). On CUDA tensors it makes one
cooperative launch of the kernel, which reads and writes only device
memory; on CPU tensors it runs the plain version (the host pass); on
anything else it raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.serial_pass.ref import serial_pass_ref

launches = 0


@functools.lru_cache(maxsize=None)
def scratch_ints() -> int:
    """Words of scratch a launch takes (kernel.cu's SCRATCH_INTS); builds
    the library, so it needs CUDA."""
    return _build.load("serial_pass").serial_pass_scratch_ints()


def _launch(vkey, valive, vver, ecnt, adj_packed, adj_in_packed, opcode,
            key1, key2, expect, mask, res):
    global launches
    dev = vkey.device
    v, w = adj_packed.shape
    b = opcode.shape[0]
    _build.check_tensor(vkey, "vkey", torch.int32, (v,), dev)
    _build.check_tensor(valive, "valive", torch.bool, (v,), dev)
    _build.check_tensor(vver, "vver", torch.int32, (v,), dev)
    _build.check_tensor(ecnt, "ecnt", torch.int32, (v,), dev)
    _build.check_tensor(adj_packed, "adj_packed", torch.int32, (v, w), dev)
    _build.check_tensor(adj_in_packed, "adj_in_packed", torch.int32, (v, w),
                        dev)
    for t, name in ((opcode, "opcode"), (key1, "key1"), (key2, "key2"),
                    (expect, "expect"), (res, "res")):
        _build.check_tensor(t, name, torch.int32, (b,), dev)
    _build.check_tensor(mask, "mask", torch.bool, (b,), dev)
    # the barrier's arrivals and the lookups' ring start at zero
    scratch = torch.zeros(scratch_ints(), dtype=torch.int32, device=dev)
    _build.launch("serial_pass", "serial_pass_launch", dev, vkey, valive,
                  vver, ecnt, adj_packed, adj_in_packed, opcode, key1, key2,
                  expect, mask, res, scratch, b, v, w)
    launches += 1
    return res


def serial_pass(vkey, valive, vver, ecnt, adj_packed, adj_in_packed, opcode,
                key1, key2, expect, mask, res):
    """Apply the ``mask``-selected lanes in place, in lane order; their
    codes go into ``res``, which is returned."""
    if vkey.is_cuda:
        return _launch(vkey, valive, vver, ecnt, adj_packed, adj_in_packed,
                       opcode, key1, key2, expect, mask, res)
    if vkey.device.type == "cpu":
        return serial_pass_ref(vkey, valive, vver, ecnt, adj_packed,
                               adj_in_packed, opcode, key1, key2, expect,
                               mask, res)
    raise ValueError(f"no serial pass kernel for device {vkey.device}")
