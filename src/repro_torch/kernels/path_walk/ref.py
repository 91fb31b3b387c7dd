"""Plain version of the device path walk: the walk on the host.

``path_walk_ref`` is the kernel's contract. For each query q it follows
the parent chain of ``parent[q]`` (int32[Q, V]) from ``dst_slot[q]`` back to
``src_slot[q]`` as ``core.bfs.extract_path`` does: the next slot is -1 if
the current one is the source, else its parent; the walk stops at a
negative slot or after V slots (and at a slot outside [0, V), where the
host walk would raise). Row q of the int32[Q, 2 + cap] result holds
``found[q]`` (1 or 0), the path's length n (0 where ``found[q]`` is
false), then ``vkey`` at the first min(n, cap) slots of the path in
source-to-destination order, padded with -1. The result is on
``parent``'s device.

Only the path's slots are visited: no V-length array is made a query.
This is the walk of sessions whose forest is on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

# path keys a row holds: a session brings home [Q, 2 + CAP] words, and
# walks again at the longest length where a path is longer
CAP = 256


def path_walk_ref(parent, found, src_slot, dst_slot, vkey, cap: int = CAP):
    """int32[Q, 2 + cap] on ``parent``'s device (module docstring)."""
    par = parent.cpu().numpy()
    fnd = found.cpu().numpy()
    src = src_slot.cpu().numpy()
    dst = dst_slot.cpu().numpy()
    keys = vkey.cpu().numpy()
    q_n, v = par.shape
    out = np.full((q_n, 2 + cap), -1, np.int32)
    for q in range(q_n):
        slots = []
        if fnd[q]:
            s, cur = int(src[q]), int(dst[q])
            while 0 <= cur < v and len(slots) < v:
                slots.append(cur)
                cur = -1 if cur == s else int(par[q, cur])
        head = slots[::-1][:cap]
        out[q, 0] = int(bool(fnd[q]))
        out[q, 1] = len(slots)
        out[q, 2:2 + len(head)] = keys[head]
    return torch.from_numpy(out).to(parent.device)
