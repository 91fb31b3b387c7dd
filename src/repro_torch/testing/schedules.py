"""Schedule-exploring linearizability and crash-recovery harness for the
port's multi-tenant ingestion: the port of ``repro.testing.schedules``
(DESIGN.md §12, §16), on dense states.

It generates N-client schedules (interleaved batch submissions, admission
rounds and snapshot reads) with a controllable conflict rate, executes
them against the port's ``IngestPool`` and checks the paper's
linearizability claim restated at serving scale:

  the final state of any admitted parallel execution is BIT-identical to
  *some* serial order of the client batches (the pool's claimed
  linearization replayed through the sequential engine ``apply_ops`` and
  the sequential oracle ``GraphOracle``), and every read observed a state
  some linearization prefix produces.

Layers:

  * generation: ``gen_client_programs`` (conflict-rate controlled),
    ``random_schedule`` (seeded interleavings), ``enumerate_interleavings``
    (exact enumeration for small programs). The same seed gives the same
    schedule as the JAX package's, so one schedule drives both pools;
  * execution: ``run_schedule`` drives a schedule through an IngestPool on
    the card unless ``device`` names another, optionally durable
    (``durable_dir``: a WAL and cadence checkpoints), and returns a
    ``Trace``; a ``FaultInjector`` durability stage ends the run with the
    published prefix captured in ``Trace.crash``;
  * checking: ``check_trace_linearizable`` (program order, oracle results,
    bit-identity, read consistency, within-round commutativity),
    ``check_aborted_invisible``, and ``check_recovery_equivalent``: a pool
    recovered from the trace's WAL + checkpoint reproduces the pre-crash
    published prefix bit for bit.

The layers above are wrapped for property suites as in JAX: the strategy
factories ``op_strategy`` / ``batch_strategy`` / ``batch_lists_strategy``
(over hypothesis or ``testing.proptest``; ``schedule_from_batches`` makes a
schedule of their draws), ``run_and_check`` (run then
check) and ``shrink_schedule`` (a deterministic minimizer, printed with
``Schedule.pretty``). With ``mesh=`` the pool runs a mesh-sharded state
(``core.partition``) and recovery lands on the same mesh; every check reads
the gathered state, as the JAX harness does.
"""
from __future__ import annotations

import itertools
import os
import random
from dataclasses import dataclass, field

import numpy as np

from repro_torch.convert import state_to_numpy
from repro_torch.core import partition
from repro_torch.core.graph import (OP_ADD_E, OP_ADD_V, OP_CON_E, OP_CON_V,
                                    OP_REM_E, OP_REM_V, OPCODE_NAMES,
                                    R_TABLE_FULL, GraphState, grow,
                                    make_graph, make_op_batch)
from repro_torch.core.oracle import GraphOracle
from repro_torch.core.ops import apply_ops
from repro_torch.core.snapshot import get_paths_session
from repro_torch.runtime.fault import SimulatedCrash
from repro_torch.runtime.ingest import IngestPool
from repro_torch.runtime.recovery import GraphCheckpointer, recover
from repro_torch.runtime.wal import WriteAheadLog

# ---------------------------------------------------------------------------
# Schedule representation
# ---------------------------------------------------------------------------
# Steps (plain tuples so schedules print trivially):
#   ("submit", client_id, [op, ...])   enqueue one client batch
#   ("pump",)                          one admission round
#   ("read", [(k, l), ...])            reachability read on the published epoch
#   ("read_epoch", [(k, l), ...])      HOSTILE wait-free read: every state
#                                      fetch ships a fresh mutation touching
#                                      the query's dependency set first, so
#                                      the session must resolve against a
#                                      pinned published epoch (DESIGN.md §13)
#   ("tt", back, [(k, l), ...])        time-travel read at the epoch ``back``
#                                      publishes before the newest (clamped
#                                      to the retention window)
#   ("flush",)                         drain the queue


@dataclass
class Schedule:
    steps: list = field(default_factory=list)

    def submits(self):
        return [s for s in self.steps if s[0] == "submit"]

    def pretty(self) -> str:
        """Readable transcript: what a shrunk counterexample prints as."""
        lines = []
        for i, s in enumerate(self.steps):
            if s[0] == "submit":
                ops = ", ".join(_op_str(op) for op in s[2])
                lines.append(f"{i:3d}  submit {s[1]:<8} [{ops}]")
            elif s[0] in ("read", "read_epoch"):
                pairs = ", ".join(f"{k}->{l}" for k, l in s[1])
                lines.append(f"{i:3d}  {s[0]:<6} {pairs}")
            elif s[0] == "tt":
                pairs = ", ".join(f"{k}->{l}" for k, l in s[2])
                lines.append(f"{i:3d}  tt -{s[1]:<4} {pairs}")
            else:
                lines.append(f"{i:3d}  {s[0]}")
        return "\n".join(lines)


def _op_str(op) -> str:
    name = OPCODE_NAMES.get(op[0], f"op{op[0]}")
    body = "/".join(str(x) for x in op[1:3][: 2 if op[0] in _EDGE_OPS else 1])
    cas = f" cas={op[3]}" if len(op) > 3 and op[3] >= 0 else ""
    return f"{name} {body}{cas}"


_EDGE_OPS = (OP_ADD_E, OP_REM_E, OP_CON_E)
_ALL_OPS = (OP_ADD_V, OP_REM_V, OP_CON_V, OP_ADD_E, OP_REM_E, OP_CON_E)


# ---------------------------------------------------------------------------
# Generation (the JAX module's draws, call for call)
# ---------------------------------------------------------------------------
def _norm(op) -> tuple:
    """Normalize to a (opcode, k1, k2, expect) 4-tuple."""
    k1 = op[1] if len(op) > 1 else -1
    k2 = op[2] if len(op) > 2 else -1
    ex = op[3] if len(op) > 3 else -1
    return (int(op[0]), int(k1), int(k2), int(ex))


def gen_op(rng: random.Random, keys, *, remv_rate=0.15, cas_rate=0.15):
    """One random op over the given key pool."""
    r = rng.random()
    if r < remv_rate:
        opc = OP_REM_V
    else:
        opc = rng.choice([OP_ADD_V, OP_ADD_V, OP_CON_V, OP_ADD_E, OP_ADD_E,
                          OP_REM_E, OP_CON_E])
    k1, k2 = rng.choice(keys), rng.choice(keys)
    ex = rng.choice([0, 1, 2]) \
        if opc in (OP_ADD_E, OP_REM_E) and rng.random() < cas_rate else -1
    return (opc, k1, k2, ex)


def gen_client_programs(rng: random.Random, *, clients=3, batches_per_client=2,
                        max_lanes=5, hot_keys=4, private_keys=3,
                        conflict_rate=0.5, remv_rate=0.1, cas_rate=0.15):
    """Per-client batch programs with a controllable conflict rate: each
    client owns a private key range, and with probability
    ``conflict_rate`` an op draws its keys from the SHARED hot set instead
    (0 makes every batch pairwise entity-disjoint, 1 funnels everything
    through the hot set)."""
    hot = list(range(hot_keys))
    programs: dict[str, list[list]] = {}
    for c in range(clients):
        cid = f"c{c}"
        private = list(range(100 * (c + 1), 100 * (c + 1) + private_keys))
        batches = []
        for _ in range(batches_per_client):
            lanes = rng.randint(1, max_lanes)
            ops = []
            for _ in range(lanes):
                pool = hot if rng.random() < conflict_rate else private
                ops.append(_norm(gen_op(rng, pool, remv_rate=remv_rate,
                                        cas_rate=cas_rate)))
            batches.append(ops)
        programs[cid] = batches
    return programs


def _read_keys(programs) -> list[int]:
    keys = sorted({k for batches in programs.values() for ops in batches
                   for op in ops for k in op[1:3] if k >= 0})
    return keys or [0]


def random_schedule(rng: random.Random, programs, *, read_rate=0.3,
                    pump_rate=0.5, reads_pairs=2, epoch_read_rate=0.0,
                    tt_read_rate=0.0) -> Schedule:
    """Seeded random interleaving of the client programs: per-client
    submission order is kept, pump and read steps are sprinkled between
    submissions, and a trailing flush + read ends every schedule drained.
    ``epoch_read_rate``/``tt_read_rate`` add hostile epoch-resolved and
    time-travel reads; at 0 they draw nothing from ``rng``."""
    pending = {c: list(batches) for c, batches in programs.items()}
    keys = _read_keys(programs)
    steps: list = []
    while any(pending.values()):
        c = rng.choice([c for c, b in pending.items() if b])
        steps.append(("submit", c, pending[c].pop(0)))
        if rng.random() < pump_rate:
            steps.append(("pump",))
        if rng.random() < read_rate:
            pairs = [(rng.choice(keys), rng.choice(keys))
                     for _ in range(reads_pairs)]
            steps.append(("read", pairs))
        if epoch_read_rate > 0 and rng.random() < epoch_read_rate:
            pairs = [(rng.choice(keys), rng.choice(keys))
                     for _ in range(reads_pairs)]
            steps.append(("read_epoch", pairs))
        if tt_read_rate > 0 and rng.random() < tt_read_rate:
            pairs = [(rng.choice(keys), rng.choice(keys))
                     for _ in range(reads_pairs)]
            steps.append(("tt", rng.randint(0, 4), pairs))
    steps.append(("flush",))
    steps.append(("read", [(keys[0], keys[-1]), (keys[-1], keys[0])]))
    return Schedule(steps)


def enumerate_interleavings(programs, *, pump_after_each=True, limit=64):
    """EVERY merge order of the per-client batch sequences (small
    programs), at most ``limit`` schedules; each submission is followed by
    an admission round when ``pump_after_each``, and every schedule ends
    drained."""
    clients = sorted(programs)
    tokens = [c for c in clients for _ in programs[c]]
    seen = set()
    count = 0
    for perm in itertools.permutations(tokens):
        if perm in seen:
            continue
        seen.add(perm)
        idx = {c: 0 for c in clients}
        steps: list = []
        for c in perm:
            steps.append(("submit", c, programs[c][idx[c]]))
            idx[c] += 1
            if pump_after_each:
                steps.append(("pump",))
        steps.append(("flush",))
        yield Schedule(steps)
        count += 1
        if count >= limit:
            return


# ---------------------------------------------------------------------------
# Hypothesis-style strategy factories (shared with the engine prop suites)
# ---------------------------------------------------------------------------
def op_strategy(st, *, max_key=5, cas_choices=(-1, -1, -1, 0, 1, 2)):
    """(opcode, k1, k2, expect) strategy over a small colliding key space.

    ``st`` is either the real ``hypothesis.strategies`` or the
    ``repro_torch.testing.proptest`` fallback: both expose the same
    factories."""
    keys = st.integers(min_value=0, max_value=max_key)
    opc = st.sampled_from(list(_ALL_OPS))
    return st.tuples(opc, keys, keys, st.sampled_from(list(cas_choices)))


def batch_strategy(st, *, min_size=1, max_size=10, **op_kw):
    return st.lists(op_strategy(st, **op_kw), min_size=min_size,
                    max_size=max_size)


def batch_lists_strategy(st, *, min_batches=1, max_batches=4, **batch_kw):
    """Lists of op batches: the engine property suites' input shape."""
    return st.lists(batch_strategy(st, **batch_kw), min_size=min_batches,
                    max_size=max_batches)


def schedule_from_batches(op_lists, *, clients=3) -> Schedule:
    """A schedule of ``batch_lists_strategy``'s draws (the port's own
    helper; the JAX suites feed those draws to the engines directly): batch
    i is client ``i % clients``'s next submission, each followed by one
    admission round and a reachability read of the batch's first (k1, k2)
    pairs on the published epoch, and the queue drained at the end."""
    steps = []
    for i, ops in enumerate(op_lists):
        ops = [tuple(int(x) for x in op) for op in ops]
        steps.append(("submit", f"c{i % clients}", ops))
        steps.append(("pump",))
        steps.append(("read", [(op[1], op[2]) for op in ops[:2]]))
    steps.append(("flush",))
    return Schedule(steps)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------
@dataclass
class ReadObs:
    epoch: int             # the epoch the observation linearizes at
    pairs: list
    results: list          # [(found, keys)] per pair
    mode: str = "head"     # "head" | "epoch" (wait-free resolved) | "tt"
    starved: bool = False  # session exhausted its budget (mode "epoch")


@dataclass
class CrashInfo:
    """Everything the harness snapshotted at the instant a durability
    crash stage killed the pool: the published prefix the recovered
    process must reproduce bit for bit. Fields are host arrays with the
    JAX package's dtypes (the word matrices uint32)."""

    stage: str                 # FaultInjector stage that fired
    step_index: int            # schedule step the crash landed in
    epoch_attempted: int       # epoch the dying round would have published
    published_epoch: int       # last epoch visible to readers pre-crash
    linearization: list        # published linearization prefix at crash
    epoch_log: dict            # epoch -> prefix length map at crash
    acked: list                # batch_ids acknowledged (status "applied")
    head_fields: dict          # field -> np.ndarray of the published head
    ring_states: dict          # epoch -> {field -> np.ndarray} over window


@dataclass
class Trace:
    schedule: Schedule
    pool: IngestPool
    capacity: int          # initial capacity the pool started from
    device: object         # the torch device the pool ran on
    reads: list = field(default_factory=list)
    durable_dir: str | None = None   # WAL + checkpoint root (None = undurable)
    crash: CrashInfo | None = None   # set when a durability stage killed the run
    mesh: object = None    # the GraphMesh of a sharded pool (None = dense)

    @property
    def linearization(self):
        return self.pool.linearization


def host_fields(state) -> dict:
    """field -> host array of a dense or sharded state (gathered), the
    word matrices as uint32."""
    if isinstance(state, partition.ShardedGraphState):
        state = partition.unshard(state)
    return dict(zip(GraphState._fields, state_to_numpy(state)))


def _hostile_epoch_read(pool: IngestPool, pairs, *, max_rounds=3) -> ReadObs:
    """One wait-free read under the worst adversary: every state fetch
    first commits a mutation that bumps the ``ecnt`` of every query source
    (a fresh sink vertex plus one out-edge per source), so consecutive
    collects never match and the session resolves against a pinned
    published epoch, which tags the observation."""
    srcs = sorted({int(k) for k, _ in pairs})
    last_epoch = [pool.epoch]

    def hostile_fetch():
        fresh = 9000 + pool.stats.submitted   # outside every client key range
        pool.submit("_hostile", [_norm((OP_ADD_V, fresh))]
                    + [_norm((OP_ADD_E, k, fresh)) for k in srcs])
        pool.pump()
        epoch, snap = pool.snapshot_epoch()
        last_epoch[0] = epoch
        return snap

    st: dict = {}
    out, _ = get_paths_session(hostile_fetch, pairs, max_rounds=max_rounds,
                               on_conflict="epoch",
                               fetch_epoch=pool.snapshot_epoch, stats=st)
    epoch = st["epoch"] if st["epoch"] is not None else last_epoch[0]
    return ReadObs(int(epoch), list(pairs), out, mode="epoch",
                   starved=bool(st["starved"]))


def run_schedule(schedule: Schedule, *, capacity=32, mesh=None, fault=None,
                 auto_grow=True, max_inflight=8, max_coalesce_lanes=256,
                 pad_lanes=True, retain_epochs=64, durable_dir=None,
                 ckpt_every=0, device=None) -> Trace:
    """Execute a schedule against a fresh IngestPool on the card (unless
    ``device`` names another); returns its Trace. Reads are taken against
    the pool's PUBLISHED snapshot epoch, so each observation is tagged with
    the linearization prefix it must be explained by.

    ``durable_dir`` attaches a WAL (and, with ``ckpt_every`` > 0, cadence
    checkpoints) under that directory. A ``FaultInjector`` durability
    stage then kills the run mid-schedule: the trace comes back with
    ``crash`` set to the published prefix snapshot.
    """
    if mesh is not None:
        state = partition.shard_state(
            mesh, make_graph(capacity, device=mesh.device))
    else:
        state = make_graph(capacity, device=device)
    wal = ckpt = None
    if durable_dir is not None:
        wal = WriteAheadLog(os.path.join(durable_dir, "wal.log"))
        ckpt = GraphCheckpointer(os.path.join(durable_dir, "ckpt"))
    pool = IngestPool(state, mesh=mesh, auto_grow=auto_grow,
                      max_inflight=max_inflight,
                      max_coalesce_lanes=max_coalesce_lanes,
                      pad_lanes=pad_lanes, fault=fault,
                      retain_epochs=retain_epochs, wal=wal, ckpt=ckpt,
                      ckpt_every=ckpt_every)
    trace = Trace(schedule, pool, capacity, state.device,
                  durable_dir=durable_dir, mesh=mesh)
    step_index = 0
    try:
        for step_index, step in enumerate(schedule.steps):
            if step[0] == "submit":
                pool.submit(step[1], step[2])
            elif step[0] == "pump":
                pool.pump()
            elif step[0] == "flush":
                pool.flush()
            elif step[0] == "read":
                epoch, snap = pool.snapshot_epoch()
                out, _ = get_paths_session(lambda: snap, step[1])
                trace.reads.append(ReadObs(epoch, list(step[1]), out))
            elif step[0] == "read_epoch":
                trace.reads.append(_hostile_epoch_read(pool, step[1]))
            elif step[0] == "tt":
                lo, hi = pool.epoch_window()
                epoch = max(lo, hi - int(step[1]))
                snap = pool.state_at(epoch)
                out, _ = get_paths_session(lambda: snap, step[2])
                trace.reads.append(ReadObs(epoch, list(step[2]), out,
                                           mode="tt"))
            else:
                raise ValueError(f"unknown step {step!r}")
        step_index = len(schedule.steps)
        pool.flush()       # every trace ends drained (checkable end state)
    except SimulatedCrash as exc:
        # the process is "dead": snapshot the published prefix the
        # recovered one must be proven bit-identical to
        trace.crash = _capture_crash(pool, exc, step_index)
        if wal is not None:
            wal.close()
    return trace


def _capture_crash(pool: IngestPool, exc: SimulatedCrash,
                   step_index: int) -> CrashInfo:
    """Freeze everything a pre-crash reader could have observed: the
    published head, every retained ring epoch, the linearization prefix,
    and the set of acknowledged batches."""
    epoch, snap = pool.snapshot_epoch()
    lo, hi = pool.ring.window()
    ring_states = {e: host_fields(pool.state_at(e))
                   for e in range(lo, hi + 1)}
    acked = sorted(bid for bid, t in pool.tickets.items()
                   if t.status == "applied")
    return CrashInfo(stage=exc.stage, step_index=step_index,
                     epoch_attempted=int(exc.epoch),
                     published_epoch=int(epoch),
                     linearization=list(pool.linearization),
                     epoch_log=dict(pool.epoch_log), acked=acked,
                     head_fields=host_fields(snap), ring_states=ring_states)


# ---------------------------------------------------------------------------
# Checking
# ---------------------------------------------------------------------------
def _serial_state(trace: Trace, order):
    """Replay ``order`` through the sequential engine ``apply_ops``, batch
    by batch, with the same grow-on-overflow discipline: (state, results
    by batch id), the serial execution the parallel one must equal."""
    state = make_graph(trace.capacity, device=trace.device)
    results = {}
    for bid in order:
        t = trace.pool.tickets[bid]
        batch = make_op_batch(t.ops, device=trace.device)
        state2, res = apply_ops(state, batch)
        res = res.cpu().numpy()
        while trace.pool.auto_grow and (res == R_TABLE_FULL).any():
            state = grow(state, 2 * state.capacity)
            state2, res = apply_ops(state, batch)
            res = res.cpu().numpy()
        state = state2
        results[bid] = res
    return state, results


def _assert_fields_equal(got: dict, want: dict, what: str) -> None:
    for name, a in want.items():
        np.testing.assert_array_equal(got[name], a,
                                      err_msg=f"{what} in field {name!r}")


def check_trace_linearizable(trace: Trace, *, permute_limit=24) -> None:
    """Assert the trace is linearizable (DESIGN.md §12). Five obligations:

    1. the claimed linearization is exactly the applied batches, once each,
       respecting every client's program (submission) order;
    2. oracle equivalence: replaying it through the sequential oracle
       reproduces every delivered result code;
    3. bit-identity: replaying it through ``apply_ops`` batch by batch
       reproduces the pool head bit for bit;
    4. read consistency: every read equals BFS over the oracle state at its
       snapshot epoch's linearization prefix;
    5. commutativity: batches coalesced into ONE fused call are entity-
       disjoint, so any within-round permutation is oracle-equivalent
       (``permute_limit`` caps the permutations tried per round).
    """
    pool = trace.pool
    lin = list(pool.linearization)
    applied = {bid for bid, t in pool.tickets.items() if t.status == "applied"}

    # (1) claimed order is a permutation of the applied set, program order kept
    assert sorted(lin) == sorted(applied), \
        f"linearization {lin} != applied set {sorted(applied)}"
    by_client: dict[str, list[int]] = {}
    for bid in lin:
        by_client.setdefault(pool.tickets[bid].client_id, []).append(bid)
    for cid, bids in by_client.items():
        assert bids == sorted(bids), \
            f"client {cid} program order violated in linearization: {bids}"

    # (2) oracle replay reproduces every delivered result code
    final_cap = pool._head.capacity
    oracle = _oracle_after(trace, lin, capacity=final_cap)

    # (3) bit-identity against the serial reference replay
    serial_state, serial_results = _serial_state(trace, lin)
    _assert_fields_equal(host_fields(pool._head), host_fields(serial_state),
                         "parallel execution diverges from its serial order")
    for bid in lin:
        np.testing.assert_array_equal(
            pool.tickets[bid].results, serial_results[bid],
            err_msg=f"batch {bid} results diverge from serial replay")

    # (4) reads: explained by the linearization prefix at their epoch (head,
    # wait-free epoch-resolved and time-travel reads alike)
    for obs in trace.reads:
        prefix = pool.epoch_log.get(obs.epoch)
        if prefix is None:
            # the epoch left the bounded retention window between the read
            # and the check: no prefix left to validate against
            continue
        ora = _oracle_after(trace, lin[:prefix], capacity=final_cap,
                            check_results=False)
        for (k, l), (found, keys) in zip(obs.pairs, obs.results):
            want = ora.reachable(k, l)
            assert found == want, \
                (f"read {k}->{l} at epoch {obs.epoch} saw found={found}, "
                 f"prefix state says {want}")
            if found:
                assert ora.is_valid_path(keys, k, l), \
                    f"read {k}->{l} returned a non-path {keys}"

    # (5) within-round commutativity
    for group in fused_groups(trace):
        if len(group) < 2:
            continue
        pos = {bid: i for i, bid in enumerate(lin)}
        for perm in itertools.islice(
                itertools.permutations(group), permute_limit):
            order = list(lin)
            for slot, bid in zip(sorted(pos[b] for b in group), perm):
                order[slot] = bid
            alt = _oracle_after(trace, order, capacity=final_cap)
            assert alt.state_tuple() == oracle.state_tuple(), \
                (f"round {group} does not commute: permutation {perm} "
                 f"reaches a different abstract state")


def fused_groups(trace: Trace) -> list[list[int]]:
    """Batch-id groups coalesced into one fused apply, per publish epoch."""
    log = trace.pool.epoch_log
    groups = []
    for epoch in sorted(log):
        if epoch == 0 or epoch - 1 not in log:
            # the predecessor was pruned out of the retention window: the
            # group boundary is unrecoverable
            continue
        lo, hi = log[epoch - 1], log[epoch]
        groups.append(trace.pool.linearization[lo:hi])
    return groups


def _oracle_after(trace: Trace, order, *, capacity, check_results=True
                  ) -> GraphOracle:
    """Oracle state after replaying ``order``; optionally asserts each
    batch's delivered result codes match the oracle's."""
    oracle = GraphOracle(capacity)
    for bid in order:
        t = trace.pool.tickets[bid]
        want = oracle.apply_batch([_norm(op) for op in t.ops])
        if check_results:
            got = [int(x) for x in t.results]
            assert got == want, \
                (f"batch {bid} (client {t.client_id}) results {got} diverge "
                 f"from oracle {want} in order {list(order)}")
    return oracle


def check_aborted_invisible(trace: Trace) -> None:
    """Fault-injection obligation: aborted batches left NO trace (the head
    is produced by the completed batches alone, no torn fused apply) and
    their entity locks were released (DESIGN.md §12)."""
    pool = trace.pool
    aborted = [t for t in pool.tickets.values() if t.status == "aborted"]
    for t in aborted:
        assert t.results is None, f"aborted batch {t.batch_id} has results"
        assert t.batch_id not in pool.linearization
        for entity in t.footprint:
            assert not pool.locks.held(entity), \
                f"aborted batch {t.batch_id} leaked lock on entity {entity}"
    check_trace_linearizable(trace)


# ---------------------------------------------------------------------------
# Crash recovery equivalence (DESIGN.md §16)
# ---------------------------------------------------------------------------
def recover_trace(trace: Trace):
    """Recover a fresh state from the crashed trace's WAL + checkpoint on
    the trace's device: what a restarted process would boot from. Returns
    a ``Recovered``."""
    assert trace.durable_dir is not None, "trace ran without durable_dir"
    wal = WriteAheadLog(os.path.join(trace.durable_dir, "wal.log"))
    ckpt = GraphCheckpointer(os.path.join(trace.durable_dir, "ckpt"))
    try:
        return recover(ckpt, wal, capacity=trace.capacity, mesh=trace.mesh,
                       auto_grow=trace.pool.auto_grow,
                       retain_epochs=trace.pool.ring.retain,
                       device=trace.device)
    finally:
        wal.close()


def check_recovery_equivalent(trace: Trace, recovered=None):
    """Assert a recovered pool reproduces the pre-crash published prefix
    bit for bit (DESIGN.md §16). Six obligations:

    1. zero acknowledged-batch loss: every batch acked pre-crash is in the
       recovered linearization;
    2. the pre-crash published linearization is a PREFIX of the recovered
       one (``wal-fsync``/``post-publish-pre-ack`` may extend it by the
       durable-but-unacked round, never rewrite it);
    3. bit-identity: the recovered state AT the pre-crash published epoch
       equals the captured head, field for field;
    4. ring equality: every pre-crash retained epoch still addressable
       after recovery reconstructs bit for bit;
    5. epoch_log agreement on every shared epoch;
    6. serial-oracle prefix: replaying the recovered linearization through
       the sequential engine reproduces the recovered head.

    Returns the ``Recovered`` (recovering first if not supplied).
    """
    crash = trace.crash
    assert crash is not None, "trace did not crash: nothing to recover"
    if recovered is None:
        recovered = recover_trace(trace)

    # (1) zero acknowledged-batch loss
    rec_lin = list(recovered.linearization)
    rec_set = set(rec_lin)
    for bid in crash.acked:
        assert bid in rec_set, \
            (f"acknowledged batch {bid} lost by recovery at stage "
             f"{crash.stage!r} (recovered {rec_lin})")

    # (2) published prefix preserved verbatim
    assert rec_lin[: len(crash.linearization)] == crash.linearization, \
        (f"recovered linearization {rec_lin} rewrites the pre-crash "
         f"published prefix {crash.linearization}")
    assert recovered.epoch >= crash.published_epoch, \
        (f"recovered epoch {recovered.epoch} behind published "
         f"{crash.published_epoch}")

    # (3) bit-identity at the pre-crash published epoch
    at_published = recovered.state \
        if recovered.epoch == crash.published_epoch \
        else recovered.ring.state_at(crash.published_epoch)
    _assert_fields_equal(host_fields(at_published), crash.head_fields,
                         f"recovered state diverges from the pre-crash "
                         f"published head (stage {crash.stage!r})")

    # (4) retained ring epochs reconstruct bit for bit
    rlo, rhi = recovered.ring.window()
    shared = 0
    for e, fields in crash.ring_states.items():
        if not rlo <= e <= rhi:
            continue
        shared += 1
        _assert_fields_equal(host_fields(recovered.ring.state_at(e)), fields,
                             f"ring epoch {e} diverges after recovery "
                             f"(stage {crash.stage!r})")
    assert shared > 0, \
        (f"no pre-crash epoch survived into the recovered window "
         f"[{rlo}, {rhi}]: nothing was actually proven")

    # (5) epoch_log agreement on shared epochs
    for e, prefix in crash.epoch_log.items():
        if e in recovered.epoch_log:
            assert recovered.epoch_log[e] == prefix, \
                (f"epoch {e} prefix {recovered.epoch_log[e]} != pre-crash "
                 f"{prefix}")

    # (6) serial-oracle prefix: recovered head == sequential replay of the
    # recovered linearization (grow-on-overflow discipline included)
    serial, _ = _serial_state(trace, rec_lin)
    _assert_fields_equal(host_fields(recovered.state), host_fields(serial),
                         "recovered state diverges from the serial replay "
                         "of its own linearization")
    return recovered


# ---------------------------------------------------------------------------
# Deterministic shrinking
# ---------------------------------------------------------------------------
def shrink_schedule(schedule: Schedule, still_fails) -> Schedule:
    """Greedy deterministic minimizer: repeatedly drop whole steps, then
    single ops inside submit steps, keeping any deletion under which
    ``still_fails(schedule)`` stays True. Deterministic (first-to-last
    scan to fixpoint), so a seeded failure always shrinks to the same
    readable counterexample."""
    cur = schedule
    changed = True
    while changed:
        changed = False
        # pass 1: drop whole steps
        i = 0
        while i < len(cur.steps):
            cand = Schedule(cur.steps[:i] + cur.steps[i + 1:])
            if cand.steps and still_fails(cand):
                cur, changed = cand, True
            else:
                i += 1
        # pass 2: drop individual lanes from submit steps
        i = 0
        while i < len(cur.steps):
            step = cur.steps[i]
            if step[0] == "submit" and len(step[2]) > 1:
                j = 0
                while j < len(step[2]):
                    ops = step[2][:j] + step[2][j + 1:]
                    cand = Schedule(cur.steps[:i]
                                    + [("submit", step[1], ops)]
                                    + cur.steps[i + 1:])
                    if still_fails(cand):
                        cur, changed = cand, True
                        step = cur.steps[i]
                    else:
                        j += 1
            i += 1
    return cur


def run_and_check(schedule: Schedule, **run_kw) -> Trace:
    """Execute + full linearizability check: the single entry point the
    property suites call (and ``shrink_schedule`` predicates wrap)."""
    trace = run_schedule(schedule, **run_kw)
    check_trace_linearizable(trace)
    return trace
