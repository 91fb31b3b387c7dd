"""The traversal kernels' least times: the published peaks, and the bytes
and operations each launch needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit),
copied from ``chip_smoke.py``: 3.35 TB/s of HBM and 67 T 32-bit ALU
operations a second. A launch's bound is the larger of bytes / bandwidth
and operations / ALU rate, counted as ``chip_smoke.py::_work`` counts them
(PERF.md §6's method): each input byte read once, each output written
once, and of the adjacency only what these inputs need:

  B1 (push, Q frontiers)  the frontiers, the union of the frontier rows in
                          full, alive, visited; new, parent and the reach
                          words written. Operations: an OR and a test per
                          query and nonzero word of each of its frontier
                          rows.
  B2 (pull)               the frontier words, alive, visited; new and
                          parent written; of each in-row, the words a query
                          still pending there must read: those where its
                          frontier has a bit, up to the word of the parent
                          it finds (all of them where it finds none), the
                          most over the queries. Operations: an AND and a
                          test per (query, vertex) that finds a parent, a
                          count below the need (every bound stays below
                          the least time).
  B3 (push, one frontier) as B1 with one query.

``Recorder`` wraps the kernel wrappers' launch functions from the
benchmark's side, so the program is not changed: each launch runs between
two device synchronizations, its host interval is kept for the device
trace, and its bytes and operations are summed on the device after it.
"""
from __future__ import annotations

import time

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

# kernel -> (module of its wrapper, launch function)
LAUNCHES = {"B1": ("repro_torch.kernels.bfs_multi_step.ops", "_launch"),
            "B2": ("repro_torch.kernels.bfs_pull_step.ops", "_launch"),
            "B3": ("repro_torch.kernels.bfs_step.ops", "_launch")}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def push_work(frontiers, adj_packed, alive, visited, outs):
    """(bytes, operations) of a B1 / B3 launch, as 0-d device tensors."""
    import torch

    fr = frontiers.reshape(-1, frontiers.shape[-1])
    rows = fr.any(0).nonzero().flatten()
    nz_words = (adj_packed[rows] != 0).sum(1)            # [frontier rows]
    row_bytes = adj_packed.shape[1] * adj_packed.element_size()
    nbytes = (rows.numel() * row_bytes
              + _nbytes(frontiers, alive, visited, *outs))
    ops = 2 * (fr[:, rows].sum(0).to(torch.float64) * nz_words).sum()
    return torch.tensor(float(nbytes)), ops


def pull_work(frontier_words, adj_in_rows, alive, visited, outs):
    """(bytes, operations) of a B2 launch, as 0-d device tensors."""
    import torch

    new, parent = outs
    w = adj_in_rows.shape[1]
    fw = frontier_words
    live_q = (fw != 0).any(1)
    pending = alive[None, :] & ~visited & live_q[:, None]
    have = (fw != 0).to(torch.int32).cumsum(1)           # [Q, W]
    if parent is not None:
        stop = torch.where(new, parent // 32, w - 1).clamp(0, w - 1)
        need = have.gather(1, stop.long())
    else:   # closure mode: a found parent's word is unknown, one word
        need = torch.where(new, 1, have[:, -1:].expand_as(new))
    need = torch.where(pending, need, 0)
    words = need.amax(0).to(torch.float64).sum()
    nbytes = words * 4 + _nbytes(fw, alive, visited, *outs)
    ops = 2 * new.sum().to(torch.float64)
    return nbytes, ops


class Recorder:
    """Install on the kernel wrappers, run the work, ``remove()``; then
    ``launches`` holds (kernel, host start ns, host end ns, bytes, ops)."""

    def __init__(self):
        self.launches: list = []
        self._saved: list = []
        self._pending: list = []

    def install(self) -> None:
        import importlib

        for key, (mod_name, fn) in LAUNCHES.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn)
            self._saved.append((mod, fn, orig))
            setattr(mod, fn, self._wrap(key, orig))

    def remove(self) -> None:
        for mod, fn, orig in self._saved:
            setattr(mod, fn, orig)
        self._saved = []
        self.launches = [(k, a, b, float(x), float(y))
                         for k, a, b, x, y in self._pending]
        self._pending = []

    def _wrap(self, key, orig):
        import torch

        def launch(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
            if key == "B2":
                nbytes, ops = pull_work(*args[:4], out)
            else:
                nbytes, ops = push_work(*args[:4], out)
            self._pending.append((key, t0, t1, nbytes, ops))
            return out
        return launch


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)
