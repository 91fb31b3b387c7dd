"""What a configuration and a traffic file may choose, on the CPU at
SCALE 8: the server's settings (``server``), the plain reference
(``reference``) and several clients a round (``clients``); and the
streams of the mixes without clients, pinned.

A clients mix runs against stand-ins built on the port's own
``IngestPool``, seated on a prebuilt state: a seam that
``GraphCoServer(ingest=True)`` may refuse. The refusal path is pinned on
a stand-in that refuses, so these tests hold whether the live program
refuses or seats."""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from graphbench import control  # noqa: E402
from graphbench.harness import bench, check, loop, spec  # noqa: E402
from graphbench.harness.graph500 import LoadedGraph  # noqa: E402
from graphbench.harness.traffic import OPCODE, OPS, Traffic, lane_counts  # noqa: E402
from repro_torch.runtime import serve_loop  # noqa: E402
from repro_torch.runtime.ingest import IngestPool  # noqa: E402

SCALE, CHURN = 8, 512
SECONDS = 0.3
CONFIG, MIX = "g500-s18-ingest", "clients"
CELL = f"{CONFIG}.{MIX}"
SERVER = {"ingest": True, "max_coalesce_lanes": 1024, "retain_epochs": 64}
CLIENTS = {
    "name": MIX,
    "clients": {"count": 7, "lanes": 64,
                "mix": {"AddV": 12.5, "ConV": 25, "AddE": 25, "RemE": 12.5,
                        "ConE": 25},
                "exclusive": {"every": 4, "lanes": 64,
                              "mix": {"AddV": 25, "RemV": 50, "ConV": 25}}},
    "getpath": {"queries": 8},
    "churn_keys": CHURN,
    "rem_e_lag_rounds": 8,
}
# sha256 of the first 64 rounds of each mix at SCALE 8 (the churn keys
# alive at set-up, then every round's batch and GetPath pairs), as the
# generator drew them before it learnt of clients
PINNED = [
    ("equal-gp2", 7,
     "054a53f36653c3ae9793927c33b33a81d093ba5795e40e00863ef93e26a8950f"),
    ("equal-gp2", 2**31 + 2024,
     "adbf2e7a631af07e302a59365368b95156ed60c8a2ffccfa6d6afd338eac0a46"),
    ("reach", 7,
     "1cddc9c6005bbd2710c4de6306f7ff0bca276e49f14a81d13d701c3af501dba5"),
    ("reach", 2**31 + 2024,
     "d657689471e935be51312583e20c19b07e0998b2cba2f4ad81e8dafbc080b373"),
    ("update", 7,
     "b54d4756f2e321633a48b9256d42f7a6ad10cd9ccc8712811bb3abc29f78ff4e"),
    ("update", 2**31 + 2024,
     "f34a734b9d131ad3069c8c0a8343449e175535ecc2687dbeb4ee0b5f48abd837"),
]


BASE_CFG = json.loads(
    (ROOT / "graphbench" / "configs" / "g500-s18.json").read_text())


def small_cfg(**kw) -> dict:
    return {**BASE_CFG, "scale": SCALE, "capacity": (1 << SCALE) + CHURN,
            **kw}


# -- the stand-ins -----------------------------------------------------------
class PoolServer(serve_loop.GraphCoServer):
    """The program's server with the seam it lacks today: seating a state
    where no pool is yet seats an ``IngestPool`` on it, and seating one
    after that (a compaction) publishes it as the pool's next epoch."""

    pool_cls = IngestPool
    made: list = []

    def __init__(self, *, ingest=False, max_inflight=8,
                 max_coalesce_lanes=256, retain_epochs=64, **kw):
        super().__init__(**kw)
        self.pool_args = (dict(max_inflight=max_inflight,
                               max_coalesce_lanes=max_coalesce_lanes,
                               retain_epochs=retain_epochs)
                          if ingest else None)
        self.made.append(self)

    def _seat(self, value):
        if self.pool_args is None:
            self._state = value
        elif self.pool is None:
            self.pool = self.pool_cls(value, **self.pool_args)
        else:
            self.pool._publish(value)

    state = property(serve_loop.GraphCoServer.state.fget, _seat)


class RefusingServer(serve_loop.GraphCoServer):
    """A server that refuses pool-backed ingestion: built with
    ``ingest=True``, its ``state`` setter raises, whatever the live
    program's does."""

    def __init__(self, *, ingest=False, **kw):
        super().__init__(ingest=ingest, **kw)
        self.refuses = ingest

    def _seat(self, value):
        if self.refuses:
            raise AttributeError(
                "state is pool-owned under multi-tenant ingestion; "
                "mutate through submit()/submit_client()")
        self._state = value

    state = property(serve_loop.GraphCoServer.state.fget, _seat)


class LifoPool(IngestPool):
    """Admission scans the queue newest first: legal where each client has
    one batch in the queue, and the order it claims is then not the order
    of submission."""

    def _admit(self):
        self._queue.reverse()
        try:
            return super()._admit()
        finally:
            self._queue.reverse()


class LifoServer(PoolServer):
    pool_cls = LifoPool


class ClaimsSubmissionOrder(LifoServer):
    """Applies newest first, but every batch of a round claims the round's
    first epoch, so the order it claims is that of submission."""

    def submit_client(self, client, ops):
        if self.pool.queue_depth() == 0:
            self.round = []
        t = super().submit_client(client, ops)
        self.round.append(t)
        return t

    def pump(self):
        n = super().pump()
        done = [t for t in self.round if t.status == "applied"]
        for t in done:
            t.epoch = min(d.epoch for d in done)
        return n


class Later:
    """The ticket of a batch not yet handed to the pool."""
    real = None

    def __getattr__(self, name):
        if self.real is None:
            return {"status": "queued", "epoch": 0, "batch_id": -1,
                    "results": None}[name]
        return getattr(self.real, name)


class SwapsC0(PoolServer):
    """Holds every other batch of client c0 back and hands it to the pool
    after that client's next one: the two land swapped."""
    held = None

    def submit_client(self, client, ops):
        if client != "c0":
            return super().submit_client(client, ops)
        if self.held is None:
            self.held = (ops, Later())
            return self.held[1]
        (first, later), self.held = self.held, None
        t = super().submit_client(client, ops)
        later.real = super().submit_client(client, first)
        return t


@pytest.fixture
def deployment(monkeypatch):
    """BENCHMARK.json with the cell ``g500-s18-ingest.clients`` besides
    its own (listed by every metric that lists cells, as a cell that
    both mutates and reads would be), every configuration at SCALE 8,
    and the program's server replaced by ``use(cls)``'s stand-in."""
    orig_bench, orig_read = spec.load_benchmark, spec.read_json

    def load_benchmark(root=spec.ROOT):
        b = orig_bench(root)
        b["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": MIX, "chips": 1, "why": "test"})
        for m in b["end_to_end"] + b["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(CELL)
        return b

    def read_json(kind, name):
        if (kind, name) == ("configs", CONFIG):
            return small_cfg(name=CONFIG, server=dict(SERVER))
        if (kind, name) == ("traffic", MIX):
            return CLIENTS
        d = orig_read(kind, name)
        if kind == "configs":
            return dict(d, scale=SCALE, capacity=(1 << SCALE) + CHURN)
        return dict(d, churn_keys=CHURN)

    monkeypatch.setattr(spec, "load_benchmark", load_benchmark)
    monkeypatch.setattr(spec, "read_json", read_json)
    monkeypatch.setattr(PoolServer, "made", [])

    def use(cls):
        monkeypatch.setattr(serve_loop, "GraphCoServer", cls)
        return getattr(cls, "made", None)
    return use


def run(cell, seed=1, **kw):
    return bench.run(cell, seed, SECONDS, False, device="cpu",
                     log=lambda m: None, **kw)


# -- a configuration chooses its server --------------------------------------
class Recording(serve_loop.GraphCoServer):
    calls: list = []

    def __init__(self, **kw):
        self.calls.append(kw)
        super().__init__(**kw)


@pytest.mark.parametrize("settings", [
    None, {}, {"index": False, "query_engine": "fused", "max_inflight": 4,
               "max_coalesce_lanes": 512, "retain_epochs": 16,
               "on_conflict": "retry"}])
def test_server_object_reaches_the_constructor(monkeypatch, settings):
    monkeypatch.setattr(serve_loop, "GraphCoServer", Recording)
    monkeypatch.setattr(Recording, "calls", [])
    cfg = small_cfg() if settings is None else small_cfg(server=settings)
    mix = dict(spec.read_json("traffic", "update"), churn_keys=CHURN)
    s = loop.build(cfg, mix, 3, "cpu")
    today = dict(capacity=loop.SERVER_SLOTS, index=False, ingest=False,
                 device="cpu")
    assert Recording.calls == [dict(today, **(settings or {}))]
    assert s.server.state.capacity == cfg["capacity"]


def test_unknown_server_key_fails_at_setup(monkeypatch):
    monkeypatch.setattr(serve_loop, "GraphCoServer", Recording)
    monkeypatch.setattr(Recording, "calls", [])
    cfg = small_cfg(server={"ingest": False, "wal_dir": "x", "bogus": 1})
    mix = dict(spec.read_json("traffic", "update"), churn_keys=CHURN)
    with pytest.raises(loop.SetupRefused, match="bogus, wal_dir"):
        loop.build(cfg, mix, 3, "cpu")
    assert Recording.calls == []


def test_ingest_server_stops_in_setup_with_one_line(deployment):
    """A program that refuses to seat a state in a pool-backed server
    stops the run in set-up, at once, with one line naming the setting."""
    import time

    deployment(RefusingServer)
    t = time.perf_counter()
    with pytest.raises(loop.SetupRefused) as err:
        run(CELL)
    assert time.perf_counter() - t < 60
    msg = str(err.value)
    assert "\n" not in msg and '"ingest": true' in msg
    assert "AttributeError" in msg and "pool-owned" in msg


def run_py_on_cpu(monkeypatch):
    """``run.py``'s ``main`` with the card's checks passed and the run on
    the CPU; forbidden modules are those the run itself loads."""
    sys.path.insert(0, str(ROOT / "graphbench"))
    import run as run_py
    import torch

    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setenv("GLIBC_TUNABLES", run_py.ALLOCATOR)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(run_py, "card_line", lambda: "no card")
    real, loaded = bench.run, set(sys.modules)
    monkeypatch.setattr(bench, "run", lambda *a, **kw: real(
        *a, **dict(kw, device="cpu")))
    real_forbidden = bench.forbidden_modules
    monkeypatch.setattr(bench, "forbidden_modules", lambda: real_forbidden(
        set(sys.modules) - loaded))
    return run_py.main


def test_run_exits_on_a_refused_setting(deployment, monkeypatch, capsys):
    """``run.py`` turns the refusal into exit 4, one line on standard
    error, and no result."""
    deployment(RefusingServer)
    rc = run_py_on_cpu(monkeypatch)(["--workload", CELL, "--seed", "5",
                                     "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 4 and out.out == ""
    last = out.err.strip().splitlines()[-1]
    assert last.startswith("graphbench: set-up stopped: the program refused")
    assert '"ingest": true' in last


def test_run_prints_a_correct_line_once_the_server_seats(
        deployment, monkeypatch, capsys):
    """The same cell and setting, against a program that seats the state
    in its pool: set-up passes, exit 0, a correct line last on standard
    output and the checks last on standard error."""
    made = deployment(PoolServer)
    rc = run_py_on_cpu(monkeypatch)(["--workload", CELL, "--seed", "5",
                                     "--seconds", str(SECONDS),
                                     "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] and line["attempted"] > 0
    assert made[0].pool is not None and made[0].pool.stats.applied > 0
    names = set(check.LIMITS) | set(check.CLIENT_LIMITS)
    last = out.err.strip().splitlines()[-len(names):]
    assert {ln.split()[1] for ln in last} == names
    assert all(ln.startswith("check ") for ln in last)


# -- a configuration names its reference -------------------------------------
@pytest.mark.parametrize("broken", [False, True])
def test_reference_is_the_file_the_config_names(monkeypatch, tmp_path,
                                                broken):
    src = (ROOT / "graphbench" / "harness" / "reference.py").read_text()
    if broken:       # ConV answers FALSE for every key
        right = "return R_TRUE if 0 <= k < self.nk and alive[k] else R_FALSE"
        assert right in src
        src = src.replace(right, "return R_FALSE")
    (tmp_path / "reference.py").write_text(src)
    orig = spec.read_json

    def read_json(kind, name):
        if kind == "configs":
            return small_cfg(reference=str(tmp_path / "reference.py"))
        return dict(orig(kind, name), churn_keys=CHURN)

    monkeypatch.setattr(spec, "read_json", read_json)
    line, checks = run("g500-s18.equal-gp2")
    assert line["correct"] is not broken, checks
    assert (checks["codes_wrong"][0] > 0) is broken


# -- a traffic file drives clients -------------------------------------------
def test_client_mix_through_the_pool_is_correct(deployment):
    made = deployment(PoolServer)
    line, checks = run(CELL)
    assert line["correct"], checks
    assert set(checks) == set(check.LIMITS) | set(check.CLIENT_LIMITS)
    assert all(v == 0 for v, _ in checks.values())
    assert line["failed"] == 0 and line["attempted"] > 0
    assert {"ops_per_s", "batch_p95_ms", "getpath_p95_ms",
            "setup_s"} == set(line["metrics"])
    pool = made[0].pool
    # every client's batches went through admission, some of them past a
    # conflict, and one compaction was published as an epoch
    assert pool.stats.applied == pool.stats.submitted > 0
    assert pool.stats.retries > 0
    assert pool.stats.epochs > pool.stats.fused_calls


def test_traced_client_mix_reports_its_layers(deployment):
    """A traced run of a clients mix: correct, with the endpoint's,
    the session's and the mutation's numbers of its untraced part and
    its program spans."""
    deployment(PoolServer)
    line, checks = bench.run(CELL, 6, 1.0, True, device="cpu",
                             log=lambda m: None)
    assert line["correct"], checks
    m = line["metrics"]
    assert {"serial_lanes_per_batch", "submit_ms.p50",
            "session_ms.p50"} <= set(m)
    assert m["serial_lanes_per_batch"]["value"] > 0
    assert m["submit_ms.p50"]["value"] > 0
    assert m["session_ms.p50"]["value"] > 0
    # on the CPU the device's numbers are not measured
    assert not {"idle_unexplained_pct", "device_idle_pct",
                "mutation_device_ms"} & set(m)


def test_check_follows_the_order_the_server_claims(deployment):
    """A pool that admits newest first claims another order than that of
    submission, and is correct; the same pool claiming the order of
    submission is not, by its codes."""
    made = deployment(LifoServer)
    line, checks = run(CELL)
    assert line["correct"], checks
    lin = made[0].pool.linearization
    assert lin != sorted(lin)
    deployment(ClaimsSubmissionOrder)
    line, checks = run(CELL)
    assert not line["correct"]
    assert checks["codes_wrong"][0] > 0 and checks["order_wrong"][0] == 0


def test_swapped_batches_of_one_client_are_not_correct(deployment):
    deployment(SwapsC0)
    line, checks = run(CELL)
    assert not line["correct"]
    assert checks["order_wrong"][0] > 0


@pytest.mark.parametrize("mode,number", [("hold", "order_wrong"),
                                         ("reorder", "codes_wrong")])
def test_control_of_a_client_mix_is_not_correct(deployment, mode, number):
    line = control.run_control(CELL, 4, SECONDS, mode, log=lambda m: None)
    assert not line["correct"]
    assert line["checks"][number]["value"] > 0


def test_client_rounds_drawn_from_the_mix():
    g = LoadedGraph(small_cfg(), loop.seed_seq(3, 0))
    t = Traffic(CLIENTS, g.n, g.sources, loop.seed_seq(3, 1))
    cl = CLIENTS["clients"]
    for r in (t.next() for _ in range(9)):
        assert r.ops is None and r.pairs.shape == (8, 2)
        names = [f"c{i}" for i in range(7)] + (["c7"] if r.index % 4 == 0
                                                else [])
        assert [c for c, _ in r.batches] == names
        for c, ops in r.batches:
            kind = cl["exclusive"] if c == "c7" else cl
            counts = [int((ops[:, 0] == OPCODE[op]).sum()) for op in OPS]
            assert counts == list(lane_counts(kind["lanes"], kind["mix"]))
            vert = np.isin(ops[:, 0], (OPCODE["AddV"], OPCODE["RemV"]))
            assert np.all((ops[vert, 1] >= g.n) & (ops[vert, 1] < g.n + CHURN))
    # the churn keys alive at set-up: the share AddV / (AddV + RemV) of
    # every client's lanes a round
    add, rem = 7 * 64 * 12.5 + 64 * 25 / 4, 64 * 50 / 4
    alive = loop.churn_at_start(CLIENTS, g.n, loop.seed_seq(3, 3))
    assert len(alive) == round(CHURN * add / (add + rem))


def test_submit_and_clients_exclude_each_other():
    mix = dict(CLIENTS, submit=spec.read_json("traffic", "update")["submit"])
    with pytest.raises(ValueError, match="not both"):
        Traffic(mix, 256, np.arange(256), loop.seed_seq(1, 1))


# -- a mix without clients draws what it drew --------------------------------
@pytest.mark.parametrize("mix_name,seed,digest", PINNED,
                         ids=[f"{m}-{s}" for m, s, _ in PINNED])
def test_stream_without_clients_unchanged(mix_name, seed, digest):
    mix = spec.read_json("traffic", mix_name)
    g = LoadedGraph(small_cfg(), loop.seed_seq(seed, 0))
    t = Traffic(mix, g.n, g.sources, loop.seed_seq(seed, 1))
    h = hashlib.sha256()
    h.update(loop.churn_at_start(mix, g.n, loop.seed_seq(seed, 3)).tobytes())
    for _ in range(64):
        r = t.next()
        assert r.batches is None
        for a in (r.ops, r.pairs):
            h.update(b"-" if a is None
                     else np.ascontiguousarray(a, np.int64).tobytes())
    assert h.hexdigest() == digest
