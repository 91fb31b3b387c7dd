"""The check that decides ``correct``, on the CPU at SCALE 8: the program
(``GraphCoServer``) agrees with the plain reference over a few rounds of
every mix; the control and every fault a cell can have come out as not
correct; the result line has the keys the contract names."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from graphbench import control  # noqa: E402
from graphbench.harness import bench, spec  # noqa: E402

CELLS = ("g500-s18.equal-gp2", "g500-s18.reach", "g500-s18.update")
SCALE, CHURN = 8, 512
SECONDS = 0.3


@pytest.fixture
def small(monkeypatch):
    """Every configuration at SCALE 8 with 512 free slots, every mix with
    a churn range of 512 keys (a 1,024-lane batch holds up to 231 AddV
    lanes)."""
    orig = spec.read_json

    def read_json(kind, name):
        d = orig(kind, name)
        if kind == "configs":
            return dict(d, scale=SCALE, capacity=(1 << SCALE) + CHURN)
        return dict(d, churn_keys=CHURN)

    monkeypatch.setattr(spec, "read_json", read_json)


def run(cell, seed=1, **kw):
    return bench.run(cell, seed, SECONDS, False, device="cpu",
                     log=lambda m: None, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_agrees_with_reference(small, cell):
    line, checks = run(cell)
    assert line["correct"], checks
    assert all(v == 0 for v, _ in checks.values())
    assert line["failed"] == 0 and line["attempted"] > 0


def test_result_line_keys(small):
    line, _ = run("g500-s18.equal-gp2")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    want = {m["name"] for m in spec.metrics_of(
        spec.load_benchmark(), "end_to_end", "g500-s18.equal-gp2")}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["checks"]) == set(bench.check.LIMITS)


def test_traced_line_reports_per_layer(small):
    line, _ = bench.run("g500-s18.equal-gp2", 2, 0.6, True, device="cpu",
                        log=lambda m: None)
    # on the CPU the device's numbers are not measured; the spans are
    assert {"submit_ms.p50", "session_ms.p50",
            "supersteps_per_session"} <= set(line["metrics"])
    assert line["correct"]


@pytest.mark.parametrize("cell,mode,number", [
    ("g500-s18.update", "reorder", "codes_wrong"),
    ("g500-s18.equal-gp2", "shallow", "paths_wrong"),
    ("g500-s18.reach", "shallow", "paths_wrong")])
def test_control_is_not_correct(small, cell, mode, number):
    line = control.run_control(cell, 3, SECONDS, mode, log=lambda m: None)
    assert not line["correct"]
    assert line["checks"][number]["value"] > 0


def _break(monkeypatch, fault):
    from repro_torch.runtime.serve_loop import GraphCoServer

    submit, get_paths = GraphCoServer.submit, GraphCoServer.get_paths

    def unchanged(self, ops):       # the step leaves its state unchanged
        before = self.state
        codes = submit(self, ops)
        self.state = before
        return codes

    def half(self, ops):            # half of the batch left out
        codes = submit(self, ops[:len(ops) // 2])
        return np.concatenate([codes, np.zeros(len(ops) - len(codes),
                                               np.int32)])

    def altered_code(self, ops):    # an answer altered where it is made
        codes = np.array(submit(self, ops))
        codes[len(codes) // 2] ^= 1
        return codes

    def altered_path(self, pairs, max_rounds=64):
        out, rounds = get_paths(self, pairs, max_rounds)
        found, keys = out[0]
        out[0] = (not found, keys)
        return out, rounds

    fn = {"unchanged": unchanged, "half": half, "altered_code": altered_code,
          "altered_path": altered_path}[fault]
    name = "get_paths" if fault == "altered_path" else "submit"
    monkeypatch.setattr(GraphCoServer, name, fn)


@pytest.mark.parametrize("fault,cell", [
    ("unchanged", "g500-s18.update"), ("half", "g500-s18.update"),
    ("altered_code", "g500-s18.equal-gp2"),
    ("altered_path", "g500-s18.reach")])
def test_fault_is_not_correct(small, monkeypatch, fault, cell):
    _break(monkeypatch, fault)
    line, checks = run(cell)
    assert not line["correct"], checks
