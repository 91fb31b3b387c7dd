"""Wrappers of the B4 and B8 label-join kernels (label_join/kernel.cu).

``label_join_packed`` (B4 on gathered rows), ``label_join_slots`` (B4
reading the index's rows by slot, what ``index.query_reach`` launches) and
``label_join`` (B8) keep the kernels' contracts (``ref.py``): on a CUDA
tensor each launches its kernel, on a CPU tensor it runs the plain
version, on anything else it raises. ``packed_launches``,
``slot_launches`` and ``dense_launches`` count the kernel launches. No
query padding is needed: the kernels take any Q.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.label_join.ref import (label_join_packed_ref,
                                                label_join_ref,
                                                label_join_slots_ref)

packed_launches = 0
slot_launches = 0
dense_launches = 0


def _launch(fn, out_rows, in_rows):
    q, n = out_rows.shape
    dev = out_rows.device
    for t, name in ((out_rows, "out"), (in_rows, "in")):
        _build.check_tensor(t, name, torch.int32, (q, n), dev)
    hits = torch.empty((q,), dtype=torch.int32, device=dev)
    hub = torch.empty((q,), dtype=torch.int32, device=dev)
    _build.launch("label_join", fn, dev, out_rows, in_rows, hits, hub, q, n)
    return hits, hub


def label_join_packed(out_words, in_words):
    """B4: out_words/in_words int32[Q, W] packed labels -> (hits int32[Q],
    hub int32[Q])."""
    global packed_launches
    if out_words.is_cuda:
        res = _launch("label_join_packed_launch", out_words, in_words)
        packed_launches += 1
        return res
    if out_words.device.type == "cpu":
        return label_join_packed_ref(out_words, in_words)
    raise ValueError(f"no B4 kernel for device {out_words.device}")


def _launch_slots(out_label, in_label, alive, src, dst):
    v, w = out_label.shape
    q = src.shape[0]
    dev = out_label.device
    for t, name, dt, shape in ((out_label, "out_label", torch.int32, (v, w)),
                               (in_label, "in_label", torch.int32, (v, w)),
                               (alive, "alive", torch.bool, (v,)),
                               (src, "src", torch.int32, (q,)),
                               (dst, "dst", torch.int32, (q,))):
        _build.check_tensor(t, name, dt, shape, dev)
    hits = torch.empty((q,), dtype=torch.int32, device=dev)
    hub = torch.empty((q,), dtype=torch.int32, device=dev)
    sok = torch.empty((q,), dtype=torch.bool, device=dev)
    dok = torch.empty((q,), dtype=torch.bool, device=dev)
    _build.launch("label_join", "label_join_slots_launch", dev, out_label,
                  in_label, alive, src, dst, hits, hub, sok, dok, q, w, v)
    return hits, hub, sok, dok


def label_join_slots(out_label, in_label, alive, src, dst):
    """B4 by slot: out_label/in_label int32[V, W] packed labels, alive
    bool[V], src/dst int32[Q] slots -> (hits int32[Q], hub int32[Q], src_ok
    bool[Q], dst_ok bool[Q])."""
    global slot_launches
    if out_label.is_cuda:
        res = _launch_slots(out_label, in_label, alive, src, dst)
        slot_launches += 1
        return res
    if out_label.device.type == "cpu":
        return label_join_slots_ref(out_label, in_label, alive, src, dst)
    raise ValueError(f"no B4 kernel for device {out_label.device}")


def label_join(out_rows, in_rows):
    """B8: out_rows/in_rows int32[Q, L] label slabs (a landmark counts where
    both entries are > 0) -> (hits int32[Q], hub int32[Q])."""
    global dense_launches
    if out_rows.is_cuda:
        res = _launch("label_join_launch", out_rows, in_rows)
        dense_launches += 1
        return res
    if out_rows.device.type == "cpu":
        return label_join_ref(out_rows, in_rows)
    raise ValueError(f"no B8 kernel for device {out_rows.device}")
