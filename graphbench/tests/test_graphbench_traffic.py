"""The traffic generator and the Graph500 graph: deterministic per seed,
and the stationarity rule of every mix."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from graphbench.harness import spec  # noqa: E402
from graphbench.harness.loop import seed_seq  # noqa: E402
from graphbench.harness.graph500 import LoadedGraph  # noqa: E402
from graphbench.harness.traffic import (OPCODE, OPS, Traffic,  # noqa: E402
                                        lane_counts)

MIXES = ("equal-gp2", "reach", "update")
SCALE = 8


def small_graph(seed: int) -> LoadedGraph:
    cfg = dict(spec.read_json("configs", "g500-s18"), scale=SCALE)
    return LoadedGraph(cfg, seed_seq(seed, 0))


def rounds(mix_name: str, seed: int, n: int, graph=None):
    mix = spec.read_json("traffic", mix_name)
    g = graph or small_graph(seed)
    t = Traffic(mix, g.n, g.sources, seed_seq(seed, 1))
    return mix, g, [t.next() for _ in range(n)]


def test_graph_deterministic_per_seed():
    a, b, c = small_graph(5), small_graph(5), small_graph(6)
    assert np.array_equal(a.u, b.u) and np.array_equal(a.v, b.v)
    assert not (len(a.u) == len(c.u) and np.array_equal(a.u, c.u))
    ids = a.u * a.n + a.v
    assert np.all(np.diff(ids) > 0)          # distinct, sorted
    assert a.generated == 16 << SCALE


def test_large_seed_accepted():
    _, g, rs = rounds("equal-gp2", 2**31 + 12345, 2)
    assert rs[0].ops is not None and g.edges > 0


@pytest.mark.parametrize("mix_name", MIXES)
def test_traffic_deterministic_per_seed(mix_name):
    g = small_graph(3)
    _, _, a = rounds(mix_name, 3, 12, g)
    _, _, b = rounds(mix_name, 3, 12, g)
    _, _, c = rounds(mix_name, 4, 12, g)
    for x, y in zip(a, b):
        for f in ("ops", "pairs"):
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None)
            if u is not None:
                assert np.array_equal(u, v)
    firsts = [(r.ops if r.ops is not None else r.pairs) for r in (a[0], c[0])]
    assert not np.array_equal(*firsts)


@pytest.mark.parametrize("mix_name", MIXES)
def test_stationarity_rule(mix_name):
    mix, g, rs = rounds(mix_name, 9, 40)
    n, churn = g.n, mix["churn_keys"]
    sub, gp = mix["submit"], mix["getpath"]
    added = []
    for r in rs:
        if sub is None or r.index % sub["every"]:
            assert r.ops is None
        else:
            opc, k1, k2 = r.ops.T
            counts = [int((opc == OPCODE[op]).sum()) for op in OPS]
            assert counts == list(lane_counts(sub["lanes"], sub["mix"]))
            vert = (opc == OPCODE["AddV"]) | (opc == OPCODE["RemV"])
            # loaded vertices are never removed: vertex churn stays above
            assert np.all((k1[vert] >= n) & (k1[vert] < n + churn))
            adde = opc == OPCODE["AddE"]
            assert np.all((k1[adde] < n) & (k2[adde] < n))
            look = (opc == OPCODE["ConV"]) | (opc == OPCODE["ConE"])
            assert np.all((k1[look] >= 0) & (k1[look] < n + churn))
            # RemE: first in, first out, once a pair is lag rounds old
            for lane in np.flatnonzero(opc == OPCODE["RemE"]):
                due = [a for a in added if a[0] <= r.index]
                if due:
                    assert (k1[lane], k2[lane]) == due[0][1]
                    added.remove(due[0])
                else:
                    assert k1[lane] < n and k2[lane] < n
            added += [(r.index + mix["rem_e_lag_rounds"], (a, b))
                      for a, b in zip(k1[adde], k2[adde])]
        if gp is None:
            assert r.pairs is None
        else:
            assert r.pairs.shape == (gp["queries"], 2)
            assert np.isin(r.pairs[:, 0], g.sources).all()
            assert np.all((r.pairs[:, 1] >= 0) & (r.pairs[:, 1] < n))


def test_graph_undirected():
    """Graph500's graph is undirected: every loaded arc has its reverse."""
    g = small_graph(4)
    arcs = set(zip(g.u.tolist(), g.v.tolist()))
    assert arcs and all((v, u) in arcs for u, v in arcs)


def test_sources_have_out_edges():
    g = small_graph(2)
    assert np.array_equal(g.sources, np.unique(g.u))


@pytest.mark.parametrize("lanes,mix_name", [(1004, "equal-gp2"),
                                            (64, "reach"), (1024, "update")])
def test_lane_counts_sum(lanes, mix_name):
    c = lane_counts(lanes, spec.read_json("traffic", mix_name)["submit"]["mix"])
    assert int(c.sum()) == lanes and (c >= 0).all()
