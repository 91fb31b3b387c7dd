"""The cell ``g500-s18-ingest.ingest`` on the CPU at SCALE 8, through the
live ``repro_torch`` ``GraphCoServer(ingest=True)``: the harness seats the
loaded graph and every compaction in the server's admission pool through
``state``, and the plain reference replays the batches in the order the
pool claims. Its configuration and mix name only what the harness knows,
and a traced run reads the ingest layer's three metrics."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from graphbench.harness import bench, check, loop, spec  # noqa: E402
from graphbench.harness.graph500 import LoadedGraph  # noqa: E402
from graphbench.harness.traffic import Traffic, lane_counts  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402

SCALE, CHURN = 8, 512
CONFIG, MIX = "g500-s18-ingest", "ingest"
CELL = f"{CONFIG}.{MIX}"
INGEST_METRICS = ("publish_ms.p50", "ring_host_mb_per_publish",
                  "batches_per_apply")
# the keys a mix file may hold (graphbench/harness/traffic.py), and a
# configuration's keys beside its ``server`` object
MIX_KEYS = {"name", "about", "source", "submit", "clients", "getpath",
            "churn_keys", "rem_e_lag_rounds"}
CLIENT_KEYS = {"count", "lanes", "mix", "exclusive"}
EXCLUSIVE_KEYS = {"every", "lanes", "mix"}
GRAPH_KEYS = ("scale", "edgefactor", "initiator", "graph_seed", "capacity",
              "reference", "reduced")


@pytest.fixture
def small(monkeypatch):
    """Every configuration at SCALE 8 with 512 churn keys, and the servers
    the harness builds, in order."""
    orig = spec.read_json

    def read_json(kind, name):
        d = orig(kind, name)
        if kind == "configs":
            return dict(d, scale=SCALE, capacity=(1 << SCALE) + CHURN)
        return dict(d, churn_keys=CHURN)

    made = []
    real = loop.program_server

    def program_server(*a, **kw):
        server, compact = real(*a, **kw)
        made.append(server)
        return server, compact

    monkeypatch.setattr(spec, "read_json", read_json)
    monkeypatch.setattr(loop, "program_server", program_server)
    return made


def test_cell_through_the_live_pool_is_correct(small):
    line, checks = bench.run(CELL, 2**31 + 36, 0.3, False, device="cpu",
                             log=lambda m: None)
    assert line["correct"], checks
    assert set(checks) == set(check.LIMITS) | set(check.CLIENT_LIMITS)
    assert all(v == 0 for v, _ in checks.values()), checks
    assert checks["order_wrong"][0] == 0
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"ops_per_s", "batch_p95_ms",
                                    "getpath_p95_ms", "setup_s"}
    (server,) = small
    assert type(server) is serve_loop.GraphCoServer
    pool = server.pool
    assert pool.stats.applied == pool.stats.submitted > 0
    # at 256 keys nearly every pair of 64-lane batches shares a key, so
    # batches lose admission rounds (SCALE 18 coalesces ~4 a round)
    assert pool.stats.retries > 0
    # the loaded graph, then at least set-up's compaction, were seated
    assert pool.last_seat[0] >= 2
    assert server.get_metrics()["server.grow_events"] == 0


def test_traced_cell_reads_the_ingest_layer(small):
    line, checks = bench.run(CELL, 36, 1.0, True, device="cpu",
                             log=lambda m: None)
    assert line["correct"], checks
    m = line["metrics"]
    assert set(INGEST_METRICS) <= set(m)
    assert m["publish_ms.p50"]["value"] > 0
    assert m["ring_host_mb_per_publish"]["value"] > 0
    assert 1 <= m["batches_per_apply"]["value"] <= 8
    assert {"submit_ms.p50", "serial_lanes_per_batch", "session_ms.p50",
            "supersteps_per_session"} <= set(m)
    # on the CPU the device's numbers are not measured
    assert not {"idle_unexplained_pct", "device_idle_pct",
                "mutation_device_ms"} & set(m)


def test_config_and_mix_name_only_known_keys():
    cfg = json.loads((ROOT / "graphbench" / "configs"
                      / f"{CONFIG}.json").read_text())
    base = json.loads((ROOT / "graphbench" / "configs"
                       / "g500-s18.json").read_text())
    assert cfg["name"] == CONFIG
    assert {k: cfg[k] for k in GRAPH_KEYS} == {k: base[k] for k in GRAPH_KEYS}
    assert set(cfg["server"]) <= set(loop.SERVER_KEYS)
    assert loop.server_settings(cfg) == {"ingest": True,
                                         "max_coalesce_lanes": 1024,
                                         "retain_epochs": 64}
    for key in ("clients", "lanes", "exclusive", "getpath",
                "max_coalesce_lanes", "retain_epochs", "max_inflight"):
        assert key in cfg["assumed"], key
    mix = json.loads((ROOT / "graphbench" / "traffic"
                      / f"{MIX}.json").read_text())
    assert mix["name"] == MIX and set(mix) <= MIX_KEYS
    cl = mix["clients"]
    assert set(cl) <= CLIENT_KEYS and set(cl["exclusive"]) <= EXCLUSIVE_KEYS
    assert (cl["count"], cl["lanes"]) == (7, 64)
    assert (cl["exclusive"]["every"], cl["exclusive"]["lanes"]) == (4, 64)
    assert list(lane_counts(64, cl["mix"])) == [8, 0, 16, 16, 8, 16]
    assert list(lane_counts(64, cl["exclusive"]["mix"])) == [16, 32, 16,
                                                             0, 0, 0]
    assert (mix["getpath"], mix["churn_keys"], mix["rem_e_lag_rounds"]) == (
        {"queries": 8}, 4096, 8)
    # a round of the mix: every client's batch fits one fused apply, and
    # the pool admits the 7 + 1 clients at its default max_inflight
    assert cl["count"] * cl["lanes"] <= cfg["server"]["max_coalesce_lanes"]
    assert cl["count"] + 1 == 8
    small_cfg = dict(cfg, scale=SCALE, capacity=(1 << SCALE) + CHURN)
    g = LoadedGraph(small_cfg, loop.seed_seq(3, 0))
    t = Traffic(dict(mix, churn_keys=CHURN), g.n, g.sources,
                loop.seed_seq(3, 1))
    r = t.next()
    assert r.ops is None and len(r.batches) == 8 and r.pairs.shape == (8, 2)
    assert [c for c, _ in r.batches] == [f"c{i}" for i in range(8)]


def test_benchmark_names_the_cell_and_its_metrics():
    b = spec.load_benchmark()
    entry = spec.cell(b, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        CONFIG, MIX, 1)
    (cfg,) = [c for c in b["configs"] if c["name"] == CONFIG]
    assert cfg["file"] == f"graphbench/configs/{CONFIG}.json"
    assert (ROOT / cfg["file"]).is_file()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name in INGEST_METRICS:
        assert per_layer[name]["layer"] == "ingest"
        assert per_layer[name]["workloads"] == [CELL]
        assert (ROOT / "graphbench" / "metrics" / f"{name}.py").is_file()
    assert CELL not in per_layer["parent_copy_ms.p50"]["workloads"]
    e2e = {m["name"] for m in spec.metrics_of(b, "end_to_end", CELL)}
    assert e2e == {"ops_per_s", "getpath_p95_ms", "batch_p95_ms", "setup_s"}
