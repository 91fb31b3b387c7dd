"""Wrappers of the B9 (dense) and B5 (packed) edge-write kernels
(edge_update/kernel.cu).

``edge_update`` and ``edge_update_packed`` are the JAX package's public
wrappers: they return new (adj, ecnt) and leave their inputs as they are.
On a CUDA tensor each launches its kernel on copies of ``adj`` and
``ecnt`` (the kernels write in place), on a CPU tensor it runs the plain
version (``ref.py``), on anything else it raises. ``dense_launches`` (B9)
and ``packed_launches`` (B5) count kernel launches. As in the JAX package
no path calls them: they write ``adj_packed`` and ``ecnt`` but not the
``adj_in_packed`` mirror.

Both launch through the ``*_scratch_launch`` entry points: up to
``one_block_lanes()`` lanes one block with its hash table in shared
memory, above three kernels on the stream with the table in a scratch of
``scratch_bytes(b)`` bytes that the wrapper allocates. Both give the
lane-order result.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.edge_update.ref import (edge_update_packed_ref,
                                                 edge_update_ref)

dense_launches = 0
packed_launches = 0


def one_block_lanes() -> int:
    """The most lanes one block takes (kernel.cu's ONE_BLOCK_LANES); builds
    the library, so it needs CUDA."""
    return _build.load("edge_update").edge_update_one_block_lanes()


@functools.lru_cache(maxsize=None)
def scratch_bytes(b: int) -> int:
    """Bytes of scratch the kernels need for ``b`` lanes (0 where they fit
    one block)."""
    fn = _build.load("edge_update").edge_update_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    return fn(b)


def _launch(entry, adj, ecnt, rows, cols, vals, mask, adj_dtype):
    """Launch kernel ``entry`` in place on ``adj`` and ``ecnt`` through its
    C entry point ``<entry>_scratch_launch``."""
    dev = adj.device
    b = rows.shape[0]
    n_rows, n_cols = adj.shape
    _build.check_tensor(adj, "adj", adj_dtype, (n_rows, n_cols), dev)
    _build.check_tensor(ecnt, "ecnt", torch.int32, (n_rows,), dev)
    for t, name in ((rows, "rows"), (cols, "cols"), (vals, "vals"),
                    (mask, "mask")):
        _build.check_tensor(t, name, torch.int32, (b,), dev)
    nbytes = scratch_bytes(b)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes
               else None)
    _build.launch("edge_update", f"{entry}_scratch_launch", dev, adj, ecnt,
                  rows, cols, vals, mask, scratch, b, n_rows, n_cols)
    return adj, ecnt


def _launch_dense(adj, ecnt, rows, cols, vals, mask):
    """B9 in place: adj uint8[R, C], ecnt int32[R]; rows, cols, vals, mask
    int32[B]. Returns (adj, ecnt)."""
    global dense_launches
    _launch("edge_update", adj, ecnt, rows, cols, vals, mask,
            torch.uint8)
    dense_launches += 1
    return adj, ecnt


def _launch_packed(adj_packed, ecnt, rows, cols, vals, mask):
    """B5 in place: adj_packed int32[R, W], ecnt int32[R]; rows, cols,
    vals, mask int32[B]. Returns (adj_packed, ecnt)."""
    global packed_launches
    _launch("edge_update_packed", adj_packed, ecnt, rows, cols, vals,
            mask, torch.int32)
    packed_launches += 1
    return adj_packed, ecnt


def edge_update(adj, ecnt, rows, cols, vals, mask):
    """Apply pre-resolved edge writes to copies of adj uint8[R, C] and ecnt:
    -> (adj', ecnt'), as the JAX package's ``edge_update``."""
    if adj.is_cuda:
        return _launch_dense(adj.clone(), ecnt.clone(), rows, cols, vals,
                             mask)
    if adj.device.type == "cpu":
        return edge_update_ref(adj, ecnt, rows, cols, vals, mask)
    raise ValueError(f"no B9 kernel for device {adj.device}")


def edge_update_packed(adj_packed, ecnt, rows, cols, vals, mask):
    """The packed form on copies of adj_packed int32[R, W] and ecnt: each
    firing lane sets (vals > 0) or clears one bit -> (adj_packed', ecnt'),
    as the JAX package's ``edge_update_packed``."""
    if adj_packed.is_cuda:
        return _launch_packed(adj_packed.clone(), ecnt.clone(), rows, cols,
                              vals, mask)
    if adj_packed.device.type == "cpu":
        return edge_update_packed_ref(adj_packed, ecnt, rows, cols, vals,
                                      mask)
    raise ValueError(f"no B5 kernel for device {adj_packed.device}")
