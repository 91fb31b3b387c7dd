"""Set-up and the closed loop that drives the program.

One caller runs the rounds of a mix in order, each round one ``submit``
and/or one ``get_paths`` call on the program's ``GraphCoServer`` and a
wait for the answer, as the paper's threads each send their next op when
the last returns (lanes stand in for threads). An op's latency runs from
the start of its round to the return of the call that answered it.

A round of a ``clients`` mix instead submits each client's batch with
``submit_client``, in client order, and calls ``pump`` until every batch
it is waiting for has landed (or a pump lands none); a batch's latency
runs to the return of the pump it landed at. A batch that lands in a
later round, or in the drain after the window, is waited for there.

The store keeps a removed vertex's slot until it is compacted (the
paper's physical removal, ``repro_torch.core.ops.compact``). The caller
counts the slots from the answers it gets and compacts the store at the
start of a round whose AddV lanes could find no free slot otherwise, so
no batch ever meets a full table; the compaction's time is part of that
round. The schedule follows from the stream alone.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np

from graphbench.harness import traffic as tr
from graphbench.harness.graph500 import LoadedGraph

# answers the caller counts from (the store's published result codes)
R_TRUE = 1
SERVER_SLOTS = 32   # the server's own first state, replaced at once
# what a configuration's ``server`` object may set, passed to
# ``GraphCoServer(...)`` as keyword arguments
SERVER_KEYS = ("ingest", "index", "query_engine", "max_inflight",
               "max_coalesce_lanes", "retain_epochs", "on_conflict")


class SetupRefused(RuntimeError):
    """Set-up stopped: the configuration asks for what the harness does
    not know or the program refuses. Its message is one line."""


def seed_seq(seed: int, stream: int) -> np.random.SeedSequence:
    """Independent streams of one ``--seed`` (any whole number)."""
    return np.random.SeedSequence([abs(int(seed)), int(seed < 0), stream])


@dataclass
class TicketLog:
    """One client batch of a ``clients`` round, and what the program's
    ticket said when its batch landed."""
    client: str
    ops: np.ndarray               # int64[B, 3], as submitted
    ticket: object                # the program's ticket
    done_ns: int | None = None    # return of the pump it landed at
    status: str = "queued"        # the ticket's, once landed
    epoch: int = -1
    batch_id: int = -1
    codes: np.ndarray | None = None

    def land(self, now: int) -> None:
        t = self.ticket
        self.done_ns, self.status = now, str(t.status)
        self.epoch, self.batch_id = int(t.epoch), int(t.batch_id)
        if t.results is not None:
            self.codes = np.array(t.results).reshape(-1)

    @property
    def claimed(self) -> tuple:
        """Its place in the order the server claims."""
        return self.epoch, self.batch_id


@dataclass
class RoundLog:
    index: int
    t0: int                       # round start, perf_counter_ns
    batch: np.ndarray | None = None   # int64[B, 3] the round's ops
    pairs: np.ndarray | None = None   # int64[Q, 2] its GetPath pairs
    compacted: bool = False       # the store was compacted before its batch
    lanes: int = 0
    submit: tuple | None = None   # (start, end) ns; of a clients round,
                                  # first submit_client to last pump
    tickets: list | None = None   # [TicketLog] of a clients round
    landed: list = field(default_factory=list)   # [TicketLog] that landed
                                  # at its pumps, in the claimed order
    codes: np.ndarray | None = None
    queries: int = 0
    session: tuple | None = None  # (start, end) ns
    answers: list | None = None
    collects: int = 0
    t1: int = 0                   # round end
    cpu: int = 0                  # the caller thread's CPU ns at its end

    @property
    def ops(self) -> int:
        return self.lanes + self.queries


@dataclass
class Setup:
    cfg: dict
    mix: dict
    graph: LoadedGraph
    traffic: tr.Traffic
    server: object
    compact: object               # () -> None: compact the server's store
    capacity: int
    rounds: list = field(default_factory=list)   # every round's RoundLog
    slots_used: int = 0           # occupied slots, as the caller counts them
    churn_alive: int = 0
    compacted: bool = False       # compacted since the last round began
    churn_start: np.ndarray | None = None   # churn keys alive at set-up
    pending: list = field(default_factory=list)  # TicketLogs not landed
    drained: list = field(default_factory=list)  # landed after the rounds

    def compact_store(self) -> None:
        self.compact()
        self.slots_used = self.graph.n + self.churn_alive
        self.compacted = True


def device_state(graph: LoadedGraph, capacity: int, device, churn):
    """The store's ``GraphState`` of ``graph`` in ``capacity`` slots on
    ``device``, built there from the edge list: keys 0..N-1 in slots
    0..N-1, the ``churn`` keys (alive, with no edges) after them, every
    other slot free, ``ecnt`` the out-degree. The edges are
    distinct, so each packed word is the sum of its distinct bits, which
    equals their OR; no [V, W] array is made on the host."""
    import torch

    from repro_torch.core.graph import EMPTY_KEY, GraphState, packed_width

    n = graph.n
    w = packed_width(capacity)
    i32 = dict(dtype=torch.int32, device=device)
    slots = torch.arange(capacity, **i32)
    loaded = slots < n + len(churn)
    keys = slots.clone()
    keys[n:n + len(churn)] = torch.from_numpy(churn).to(device)
    u = graph.u_dev.to(device)
    v = graph.v_dev.to(device)
    mirrors = []
    for row, col in ((u, v), (v, u)):
        words = torch.zeros((capacity, w), **i32)
        bit = torch.ones_like(col) << (col % 32)
        bit = torch.where(bit >= 2 ** 31, bit - 2 ** 32, bit).to(torch.int32)
        words.view(-1).index_add_(0, row * w + col // 32, bit)
        mirrors.append(words)
    ecnt = torch.bincount(u, minlength=capacity).to(torch.int32)
    return GraphState(
        vkey=torch.where(loaded, keys, torch.full_like(slots, EMPTY_KEY)),
        valive=loaded.clone(),
        vver=loaded.to(torch.int32),
        ecnt=ecnt,
        adj_packed=mirrors[0],
        adj_in_packed=mirrors[1])


def server_settings(cfg: dict) -> dict:
    """The configuration's ``server`` object: keyword arguments of
    ``GraphCoServer``, none of them outside ``SERVER_KEYS``."""
    given = dict(cfg.get("server") or {})
    unknown = sorted(set(given) - set(SERVER_KEYS))
    if unknown:
        raise SetupRefused(
            f"configuration {cfg.get('name')}: unknown server setting(s) "
            f"{', '.join(unknown)}; known: {', '.join(SERVER_KEYS)}")
    return given


def program_server(graph: LoadedGraph, capacity: int, device, churn,
                   settings=None):
    """The program under test: a ``GraphCoServer`` with no index and no
    ingest pool unless ``settings`` (the configuration's ``server``
    object) say otherwise, its store seated through the ``state`` setter
    with the loaded graph and the ``churn`` keys; and a function that
    compacts that store through the same setter."""
    from repro_torch.core.ops import compact
    from repro_torch.runtime.serve_loop import GraphCoServer

    kwargs = dict(index=False, ingest=False)
    kwargs.update(settings or {})

    def refused(exc):
        return SetupRefused(
            f"the program refused the server setting(s) "
            f"{json.dumps(settings or {}, sort_keys=True)}: "
            f"{type(exc).__name__}: {exc}".replace("\n", " "))

    try:
        server = GraphCoServer(capacity=SERVER_SLOTS, device=device, **kwargs)
    except (TypeError, ValueError) as exc:
        raise refused(exc) from exc
    state = device_state(graph, capacity, server.state.device, churn)
    try:
        server.state = state
    except AttributeError as exc:
        raise refused(exc) from exc

    def compact_store():
        server.state = compact(server.state)

    return server, compact_store


def churn_at_start(mix: dict, n: int, seq) -> np.ndarray:
    """The churn keys alive at set-up, sorted: the share of the churn
    range that the mix's AddV and RemV shares hold alive in the long run
    (AddV / (AddV + RemV), over every client's lanes of a ``clients``
    mix; a half for every ``submit`` mix here), drawn from the
    seed, so that the window starts in the state it keeps."""
    sub, cl = mix.get("submit"), mix.get("clients")
    add = float(sub["mix"].get("AddV", 0)) if sub else 0.0
    rem = float(sub["mix"].get("RemV", 0)) if sub else 0.0
    if cl:
        # lanes a round of each op, over every client's batches
        kinds = [(int(cl["count"]) * int(cl["lanes"]), cl["mix"])]
        ex = cl.get("exclusive")
        if ex:
            kinds.append((int(ex["lanes"]) / int(ex["every"]), ex["mix"]))
        add = sum(n * float(m.get("AddV", 0)) for n, m in kinds)
        rem = sum(n * float(m.get("RemV", 0)) for n, m in kinds)
    churn = int(mix["churn_keys"])
    k = round(churn * add / (add + rem)) if add + rem else 0
    pick = np.random.default_rng(seq).choice(churn, size=k, replace=False)
    return n + np.sort(pick).astype(np.int64)


def build(cfg: dict, mix: dict, seed: int, device, make_server=None) -> Setup:
    """Generate the graph, the churn keys alive at the start and the
    traffic from ``seed`` and seat them in the server
    (``make_server(graph, capacity, device, churn)``, by default the
    program's under the configuration's ``server`` settings)."""
    graph = LoadedGraph(cfg, seed_seq(seed, 0), device)
    capacity = int(cfg["capacity"])
    if capacity < graph.n + int(mix["churn_keys"]):
        raise ValueError(f"capacity {capacity} holds no churn range above "
                         f"{graph.n} keys")
    churn = churn_at_start(mix, graph.n, seed_seq(seed, 3))
    traffic = tr.Traffic(mix, graph.n, graph.sources, seed_seq(seed, 1))
    make = make_server or partial(program_server,
                                  settings=server_settings(cfg))
    server, compact = make(graph, capacity, device, churn)
    s = Setup(cfg, mix, graph, traffic, server, compact, capacity,
              slots_used=graph.n + len(churn), churn_alive=len(churn))
    s.churn_start = churn
    return s


def run_round(s: Setup, rnd: tr.Round) -> RoundLog:
    """One round of the closed loop."""
    log = RoundLog(rnd.index, time.perf_counter_ns(), rnd.ops, rnd.pairs)
    if rnd.batches is not None:
        _client_batches(s, rnd, log)
    if rnd.ops is not None:
        adds = int((rnd.ops[:, 0] == tr.OPCODE["AddV"]).sum())
        if s.capacity - s.slots_used < adds:
            s.compact_store()
        ops = [tuple(op) for op in rnd.ops.tolist()]
        t = time.perf_counter_ns()
        codes = np.asarray(s.server.submit(ops))
        log.submit = (t, time.perf_counter_ns())
        log.codes = codes
        log.lanes = len(ops)
        won = codes == R_TRUE
        added = int((won & (rnd.ops[:, 0] == tr.OPCODE["AddV"])).sum())
        s.slots_used += added
        s.churn_alive += added - int(
            (won & (rnd.ops[:, 0] == tr.OPCODE["RemV"])).sum())
    if rnd.pairs is not None:
        pairs = [tuple(p) for p in rnd.pairs.tolist()]
        t = time.perf_counter_ns()
        answers, collects = s.server.get_paths(pairs)
        log.session = (t, time.perf_counter_ns())
        log.answers = answers
        log.collects = int(collects)
        log.queries = len(pairs)
    log.compacted, s.compacted = s.compacted, False
    log.t1 = time.perf_counter_ns()
    log.cpu = time.thread_time_ns()
    s.rounds.append(log)
    return log


def _client_batches(s: Setup, rnd: tr.Round, log: RoundLog) -> None:
    """A round's client batches: each submitted as its client's, in
    client order, then pumped until they have landed."""
    adds = sum(int((ops[:, 0] == tr.OPCODE["AddV"]).sum())
               for _, ops in rnd.batches)
    if s.capacity - s.slots_used < adds:
        s.compact_store()
    t = time.perf_counter_ns()
    log.tickets = [TicketLog(client, ops, s.server.submit_client(
        client, [tuple(op) for op in ops.tolist()]))
        for client, ops in rnd.batches]
    s.pending += log.tickets
    log.landed = pump(s)
    log.submit = (t, time.perf_counter_ns())
    log.lanes = sum(len(ops) for _, ops in rnd.batches)


def pump(s: Setup) -> list:
    """Pump the server's admission until every pending batch has landed,
    or a pump lands none of them; the batches that landed, in the order
    the server claims (its epochs, then its batch ids). Each is stamped
    with the return of the pump it landed at."""
    landed = []
    while s.pending:
        s.server.pump()
        now = time.perf_counter_ns()
        done = [tk for tk in s.pending if tk.ticket.status != "queued"]
        if not done:
            break
        for tk in done:
            tk.land(now)
            if tk.status == "applied" and tk.codes is not None:
                won = tk.codes[:len(tk.ops)] == R_TRUE
                opc = tk.ops[:len(won), 0]
                added = int((won & (opc == tr.OPCODE["AddV"])).sum())
                s.slots_used += added
                s.churn_alive += added - int(
                    (won & (opc == tr.OPCODE["RemV"])).sum())
        s.pending = [tk for tk in s.pending if tk.done_ns is None]
        landed += done
    return sorted(landed, key=lambda tk: tk.claimed)


def run_for(s: Setup, seconds: float) -> list:
    """Rounds until ``seconds`` have passed since the first began; the
    window closes when the round running then returns."""
    logs = []
    deadline = time.perf_counter_ns() + int(seconds * 1e9)
    while not logs or logs[-1].t1 < deadline:
        logs.append(run_round(s, s.traffic.next()))
    return logs


def warm(s: Setup, rounds: int) -> list:
    """Set-up's rounds of the cell's own shapes, and one compaction, so
    that the window meets no first call and no first allocation; the
    seconds each took."""
    took = []
    for _ in range(rounds):
        lg = run_round(s, s.traffic.next())
        took.append((lg.t1 - lg.t0) / 1e9)
    t = time.perf_counter()
    s.compact_store()
    took.append(time.perf_counter() - t)
    return took
