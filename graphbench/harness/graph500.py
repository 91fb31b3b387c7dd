"""The Graph500 graph of a configuration.

``kronecker_edges`` is the Kronecker generator of
``chip_smoke.py::graph500_edges`` (the Graph500 reference
``kronecker_generator``), step for step: R-MAT bits with the
configuration's initiator, a random relabelling of the vertices and a
shuffle of the edges. It draws from a ``torch.Generator`` on the run's
device in a few large calls, so that set-up makes a SCALE-18 graph in
milliseconds. The R-MAT bits come from the configuration's own
``graph_seed``, the relabelling and the shuffle from the run's seed: every
seed gets the same graph up to the names of its vertices, so that a seed
changes which keys the traffic meets and where they sit in the store, and
not how much work the traversals do. The same seed gives the same graph
on the same kind of device. Graph500's kernel 1 builds an undirected graph,
so each generated edge (u, v) is loaded into the store, whose edges are
directed, as the two arcs u -> v and v -> u; duplicates collapse (an arc is
present or not) and a self-loop is one arc.
"""
from __future__ import annotations

import numpy as np


def kronecker_edges(scale: int, edgefactor: int, initiator, gen, label_gen,
                    device):
    """(u, v) int64 tensors of ``edgefactor << scale`` generated edges:
    the R-MAT bits drawn from ``gen``, the relabelling and the shuffle
    from ``label_gen``."""
    import torch

    n, m = 1 << scale, edgefactor << scale
    a, b, c = initiator
    ab, c_norm, a_norm = a + b, c / (1 - (a + b)), a / (a + b)
    f64 = dict(dtype=torch.float64, device=device, generator=gen)
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for ib in range(scale):
        ii = torch.rand(m, **f64) > ab
        jj = torch.rand(m, **f64) > torch.where(ii, c_norm, a_norm)
        u |= ii.to(torch.int64) << ib
        v |= jj.to(torch.int64) << ib
    perm = torch.randperm(n, device=device, generator=label_gen)
    order = torch.randperm(m, device=device, generator=label_gen)
    return perm[u][order], perm[v][order]


class LoadedGraph:
    """The distinct arcs of a configuration's graph, both of each
    undirected edge, sorted by (u, v): ``u_dev``/``v_dev`` on the device
    for the store, ``u``/``v`` on the host for the reference; and the
    search-key pool."""

    def __init__(self, cfg: dict, seed_seq, device="cpu"):
        import torch

        self.n = 1 << int(cfg["scale"])
        bits = torch.Generator(device=device)
        bits.manual_seed(int(cfg["graph_seed"]))
        labels = torch.Generator(device=device)
        labels.manual_seed(int(seed_seq.generate_state(1, np.uint64)[0]))
        u, v = kronecker_edges(int(cfg["scale"]), int(cfg["edgefactor"]),
                               cfg["initiator"], bits, labels, device)
        self.generated = int(u.numel())
        ids = torch.unique(torch.cat((u * self.n + v, v * self.n + u)))
        self.u_dev, self.v_dev = ids // self.n, ids % self.n
        self.u = self.u_dev.cpu().numpy()
        self.v = self.v_dev.cpu().numpy()
        # Graph500 draws its search keys from the vertices of degree >= 1:
        # with both arcs loaded, those with an out-arc
        degree = np.bincount(self.u, minlength=self.n)
        self.sources = np.flatnonzero(degree > 0)

    @property
    def edges(self) -> int:
        return len(self.u)
