"""Multi-tenant bounded-concurrency ingestion for the graph server, in
PyTorch: the port of ``repro.runtime.ingest`` (DESIGN.md §12).

The admission machinery between many clients and the fused
``apply_ops_fast`` engine, round for round the JAX pool's:

  * **Conflict detection + sorted entity-ID locks.** Every client batch
    declares its entity footprint (the vertex keys its ops name).
    Admission try-acquires one lock per entity in ascending entity-ID order
    and releases in descending order, so no wait cycle can form. Batches
    whose footprints collide with an admitted batch stay queued for the
    next round (a counted retry); a FIFO scan keeps each client's program
    order.
  * **Coalescing.** The batches admitted in one round are pairwise
    entity-disjoint, so they commute; their lanes are concatenated in
    submission order into ONE ``apply_ops_fast`` call, padded to a
    power-of-two bucket (``pad`` feeds the stats and the WAL record).
  * **Epoch double-buffering.** Each fused apply lands in the non-current
    snapshot slot followed by one slot flip. Readers always see the last
    PUBLISHED epoch and never wait on admission.
  * **Retained epoch ring.** Every publish also lands one delta record in
    ``core.epochs.EpochRing`` (DESIGN.md §13): starved queries resolve
    wait-free against a pinned epoch, and ``state_at``/``epoch_diff`` serve
    time travel and audit diffs. ``epoch_log`` is pruned to its window.
  * **Linearization log.** The serial order the pool claims (admission
    order within a round, round order across rounds). Replaying it through
    the serial engine must give the pool's head bit for bit.

Batches holding RemoveVertex (or naming negative keys) are EXCLUSIVE:
RemoveVertex bumps the ``ecnt`` of every in-edge source, a cross-key effect
no footprint covers, so such a batch is admitted alone.

Faults: a ``FaultInjector`` (runtime/fault.py) can kill a client batch at
``admit`` (locks released, never applied) or at ``apply`` (the fused
result that held its lanes is discarded and recomputed from the same base
without it). R_TABLE_FULL grows the PRE-round state and replays the whole
fused batch.

Durability (DESIGN.md §16): with a ``WriteAheadLog`` every round is
committed in this order: ``_wal_commit`` appends and fsyncs the round's
record, the linearization grows and ``_publish`` flips the epoch, the
tickets are acked, and ``_maybe_checkpoint`` takes a ``GraphCheckpointer``
snapshot every ``ckpt_every`` rounds and truncates the log behind it. A
kill anywhere loses only unacknowledged work. The ``FaultInjector``'s
process-level stages (client ``"*"``) land their durable effects:
``wal-append`` a torn frame, ``wal-fsync`` a durable record never
published, ``ckpt-mid-write`` a checkpoint written but never renamed,
``post-publish-pre-ack`` a published round never acked; without a WAL the
first two only raise ``SimulatedCrash``, as the JAX pool does.

Device: batches are built on the state's device and each round's results
cross to the host once. A mesh-sharded state (``mesh=``, or a
``ShardedGraphState`` passed in) is applied through
``partition.apply_ops_fast`` and grown through ``partition.grow``, as the
JAX pool does; the ring holds it by reference like a dense state.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import partition
from repro_torch.core.distributed import GraphMesh
from repro_torch.core.epochs import EpochEvictedError, EpochRing
from repro_torch.core.graph import (OP_ADD_E, OP_ADD_V, OP_CON_E, OP_CON_V,
                                    OP_REM_E, OP_REM_V, R_TABLE_FULL, grow,
                                    make_op_batch)
from repro_torch.core.ops import apply_ops_fast
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import MetricsRegistry, StatsView
from repro_torch.obs.metrics import global_registry as _obs_registry
from repro_torch.runtime.fault import SimulatedCrash
from repro_torch.runtime.wal import WalRecord

_VERTEX_OPS = (OP_ADD_V, OP_REM_V, OP_CON_V)
_EDGE_OPS = (OP_ADD_E, OP_REM_E, OP_CON_E)


def batch_footprint(ops) -> tuple[frozenset, bool]:
    """(entity footprint, exclusive) of a client batch: the vertex keys the
    ops name, and whether a per-entity footprint cannot cover its effects
    (RemoveVertex's cross-key ecnt bumps; negative keys)."""
    keys: set[int] = set()
    exclusive = False
    for op in ops:
        opc = op[0]
        k1 = op[1] if len(op) > 1 else -1
        k2 = op[2] if len(op) > 2 else -1
        if opc in _VERTEX_OPS:
            keys.add(int(k1))
            if opc == OP_REM_V or k1 < 0:
                exclusive = True
        elif opc in _EDGE_OPS:
            keys.add(int(k1))
            keys.add(int(k2))
            if k1 < 0 or k2 < 0:
                exclusive = True
    return frozenset(keys), exclusive


class EntityLockTable:
    """Per-entity try-locks acquired in sorted entity-ID order (ascending
    acquire, descending release, all-or-nothing backout): deadlock-free by
    construction (DESIGN.md §12)."""

    def __init__(self):
        self._locks: dict[int, threading.Lock] = {}
        self._guard = threading.Lock()

    def _lock_for(self, entity: int) -> threading.Lock:
        with self._guard:
            lk = self._locks.get(entity)
            if lk is None:
                lk = self._locks[entity] = threading.Lock()
            return lk

    def try_acquire_sorted(self, footprint) -> bool:
        taken = []
        for entity in sorted(footprint):
            lk = self._lock_for(entity)
            if lk.acquire(blocking=False):
                taken.append(lk)
            else:
                for held in reversed(taken):
                    held.release()
                return False
        return True

    def release_sorted(self, footprint) -> None:
        for entity in sorted(footprint, reverse=True):
            self._locks[entity].release()

    def held(self, entity: int) -> bool:
        with self._guard:
            lk = self._locks.get(entity)
        return lk is not None and lk.locked()


@dataclass
class Ticket:
    """One client batch's journey through admission (returned by submit)."""

    batch_id: int
    client_id: str
    ops: list
    footprint: frozenset
    exclusive: bool
    enqueue_t: float
    status: str = "queued"            # queued -> applied | aborted
    results: np.ndarray | None = None
    epoch: int = 0                    # publish epoch the batch landed in
    wait_s: float = 0.0               # enqueue -> admission
    retries: int = 0                  # rounds it lost conflict detection

    @property
    def lanes(self) -> int:
        return len(self.ops)


class IngestStats(StatsView):
    """Admission observability, stored under ``ingest.<field>`` in the
    pool's registry (DESIGN.md §12, §14, §16)."""

    _PREFIX = "ingest"
    _SPEC = {
        "submitted": ("counter", 0),
        "applied": ("counter", 0),
        "aborted": ("counter", 0),
        "fused_calls": ("counter", 0),         # fused apply_ops_fast calls
        "coalesced_batches": ("counter", 0),   # client batches they carried
        "coalesce_max": ("gauge", 0),          # max batches in one fused call
        "coalesce_lanes_max": ("gauge", 0),    # max fused lanes (pre-padding)
        "retries": ("counter", 0),             # admission round losses
        "wait_s": ("counter", 0.0),            # total enqueue->admission wait
        "wait_max_s": ("gauge", 0.0),
        "queue_depth_max": ("gauge", 0),
        "queue_depth": ("gauge", 0),           # depth at the last pump
        "epochs": ("gauge", 0),                # snapshot epochs published
        "grow_events": ("counter", 0),         # R_TABLE_FULL auto-grow replays
        "epochs_retained": ("gauge", 0),       # epochs addressable in the ring
        "epochs_evicted": ("gauge", 0),        # deltas dropped by retention
        "wal_records": ("gauge", 0),           # WAL records appended (lifetime)
        "wal_bytes": ("gauge", 0),             # WAL bytes appended (lifetime)
        "wal_append_s": ("counter", 0.0),      # wall time inside WAL appends
        "wal_truncations": ("gauge", 0),       # checkpoint-driven truncations
        "ckpt_saves": ("counter", 0),          # graph checkpoints published
    }


def _next_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


class IngestPool:
    """Bounded-concurrency multi-tenant admission onto one graph state.

    ``submit`` enqueues and returns a ``Ticket``; ``pump`` runs one
    admission round (conflict detection, sorted-lock acquisition, coalesced
    fused apply, epoch publish); ``flush`` pumps until the queue drains.
    ``submit`` may be called from many threads; rounds are serialized by an
    admission mutex. The pool works on the device of ``state``.
    """

    def __init__(self, state, *, mesh=None, auto_grow: bool = True,
                 max_inflight: int = 8, max_coalesce_lanes: int = 256,
                 pad_lanes: bool = True, fault=None, on_grow=None,
                 clock=time.monotonic, retain_epochs: int = 64,
                 registry: MetricsRegistry | None = None,
                 wal=None, ckpt=None, ckpt_every: int = 0):
        if mesh is not None and not isinstance(mesh, GraphMesh):
            raise TypeError(f"IngestPool(mesh=) takes a GraphMesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh if mesh is not None else getattr(state, "mesh", None)
        if self.mesh is not None and not isinstance(
                state, partition.ShardedGraphState):
            raise TypeError(f"IngestPool(mesh=) takes a ShardedGraphState, "
                            f"got {type(state).__name__}")
        if self.mesh is not None and self.mesh != state.mesh:
            raise ValueError(f"state placed on {state.mesh}, not {self.mesh}")
        self.auto_grow = auto_grow
        self.max_inflight = int(max_inflight)
        self.max_coalesce_lanes = int(max_coalesce_lanes)
        self.pad_lanes = pad_lanes
        self.fault = fault
        self.on_grow = on_grow
        self.clock = clock
        # durability: a WriteAheadLog makes every acked round replayable; a
        # GraphCheckpointer at a round cadence bounds the log (ckpt_every=0
        # disables cadence checkpoints)
        self.wal = wal
        self.ckpt = ckpt
        self.ckpt_every = int(ckpt_every)
        self._rounds_since_ckpt = 0
        # the owning server stamps its index freshness here so cadence
        # checkpoints carry it (runtime/serve_loop.py index_tick)
        self.index_stamp: dict | None = None
        self.locks = EntityLockTable()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.stats = IngestStats(self.registry)
        self.linearization: list[int] = []   # batch_ids in claimed serial order
        self.tickets: dict[int, Ticket] = {}
        self.epoch_log: dict[int, int] = {0: 0}  # epoch -> linearization prefix
        self.ring = EpochRing(retain_epochs)
        self.ring.reset(0, state)
        self._head = state                   # writer-private latest state
        # double-buffered (epoch, state) snapshot slots; _cur flips atomically
        self._slots = [(0, state), (0, state)]
        self._cur = 0
        self._queue: list[Ticket] = []
        # queue/stats guard and one-admission-round guard (module locks,
        # not entity locks)
        self._mutex = threading.Lock()  # repro-torch-lint: allow(lock-order) — a module lock, not an entity lock
        self._admission = threading.Lock()  # repro-torch-lint: allow(lock-order) — a module lock, not an entity lock
        self._next_id = 0

    # -- read side (never blocks behind writers) ----------------------------
    def snapshot(self):
        """Latest PUBLISHED state: one read of the current slot, no lock."""
        return self._slots[self._cur][1]

    def snapshot_epoch(self):
        """(epoch, state) of the current published slot."""
        return self._slots[self._cur]

    @property
    def epoch(self) -> int:
        return self._slots[self._cur][0]

    def _publish(self, state) -> int:
        nxt = 1 - self._cur
        epoch = self._slots[self._cur][0] + 1
        self._slots[nxt] = (epoch, state)
        self._cur = nxt                      # the one flip readers see
        self._head = state
        self.stats.epochs = epoch
        self.epoch_log[epoch] = len(self.linearization)
        # record the delta (a capacity change resets the ring) and prune
        # epoch_log to the addressable window
        self.ring.push(epoch, state)
        oldest = self.ring.window()[0]
        for e in [e for e in self.epoch_log if e < oldest]:
            del self.epoch_log[e]
        self.stats.epochs_retained = len(self.ring) + 1
        self.stats.epochs_evicted = self.ring.evicted
        return epoch

    # -- retained-epoch read surface (DESIGN.md §13) ------------------------
    def epoch_window(self) -> tuple[int, int]:
        """(oldest addressable, newest published) epoch, inclusive."""
        return self.ring.window()

    def state_at(self, epoch: int):
        """The published state of a retained epoch: the current slot for
        the newest, a bit-identical ring reconstruction for older ones.
        Raises ``EpochEvictedError`` outside the retention window."""
        cur_epoch, cur_state = self._slots[self._cur]
        if int(epoch) == cur_epoch:
            return cur_state
        return self.ring.state_at(epoch)

    def epoch_diff(self, e1: int, e2: int):
        """Rows/keys touched between two retained epochs (``EpochDiff``)."""
        return self.ring.diff(e1, e2)

    def linearization_prefix(self, epoch: int) -> int:
        """Length of the linearization prefix epoch ``epoch`` published.
        Raises ``EpochEvictedError`` for epochs pruned out of the window."""
        try:
            return self.epoch_log[int(epoch)]
        except KeyError:
            raise EpochEvictedError(epoch, self.ring.window()) from None

    # -- write side ---------------------------------------------------------
    def submit(self, client_id: str, ops) -> Ticket:
        """Enqueue one client batch; returns its Ticket (resolved by pump)."""
        if not ops:
            raise ValueError("empty client batch")
        footprint, exclusive = batch_footprint(ops)
        with self._mutex:
            t = Ticket(self._next_id, str(client_id), list(ops), footprint,
                       exclusive, self.clock())
            self._next_id += 1
            self.tickets[t.batch_id] = t
            self._queue.append(t)
            self.stats.submitted += 1
            self.stats.queue_depth = len(self._queue)
            self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                             len(self._queue))
        return t

    def queue_depth(self) -> int:
        with self._mutex:
            return len(self._queue)

    def _fault_fires(self, ticket: Ticket, stage: str) -> bool:
        return self.fault is not None and self.fault.should_die(
            ticket.client_id, stage)

    def _admit(self) -> list[Ticket]:
        """Conflict-detection scan: admit a pairwise-disjoint queue subset.
        A FIFO scan; a client's later batches are blocked the moment one of
        its batches is skipped. The returned tickets HOLD their entity
        locks (released by the round, success or abort)."""
        admitted: list[Ticket] = []
        lanes = 0
        blocked_clients: set[str] = set()
        with self._mutex:
            queue = list(self._queue)
            self.stats.queue_depth = len(queue)
            self.stats.queue_depth_max = max(self.stats.queue_depth_max,
                                             len(queue))
        for t in queue:
            if len(admitted) >= self.max_inflight:
                break
            if t.client_id in blocked_clients:
                continue

            def skip(t=t):
                t.retries += 1
                with self._mutex:
                    self.stats.retries += 1
                blocked_clients.add(t.client_id)

            if admitted and (t.exclusive or any(a.exclusive for a in admitted)):
                skip()                       # exclusive batches run alone
                continue
            if lanes + t.lanes > self.max_coalesce_lanes and admitted:
                skip()                       # coalesce budget exhausted
                continue
            if not self.locks.try_acquire_sorted(t.footprint):
                skip()                       # entity conflict -> next round
                continue
            if self._fault_fires(t, "admit"):
                # died holding its locks: release and abort before it ever
                # reaches the fused batch
                self.locks.release_sorted(t.footprint)
                self._abort(t)
                blocked_clients.add(t.client_id)
                continue
            admitted.append(t)
            lanes += t.lanes
            if t.exclusive:
                break
        return admitted

    def _abort(self, t: Ticket) -> None:
        t.status = "aborted"
        with self._mutex:
            self.stats.aborted += 1
            if t in self._queue:
                self._queue.remove(t)

    def _apply_with_grow(self, base, batch):
        apply, grow_fn = ((partition.apply_ops_fast, partition.grow)
                          if self.mesh is not None else (apply_ops_fast, grow))
        state, res = apply(base, batch)
        res = res.cpu().numpy()
        while self.auto_grow and (res == R_TABLE_FULL).any():
            # grow the PRE-round state and replay the WHOLE fused batch:
            # one clean linearization on the grown table
            base = grow_fn(base, 2 * base.capacity)
            state, res = apply(base, batch)
            res = res.cpu().numpy()
            with self._mutex:
                self.stats.grow_events += 1
            _trace.counter("ingest.grow_events", self.stats.grow_events)
            if self.on_grow is not None:
                self.on_grow()
        return state, res

    def pump(self) -> int:
        """One admission round; returns the number of batches applied.
        Traced as one ``ingest.round`` span enclosing ``ingest.admit`` and
        the round's ``ingest.fused_apply``."""
        with self._admission, _trace.span("ingest.round") as sp:
            t0 = time.perf_counter()
            with _trace.span("ingest.admit"):
                admitted = self._admit()
            if not admitted:
                return 0
            try:
                applied = self._run_round(admitted)
            finally:
                for t in admitted:
                    if t.status != "aborted":  # aborted already released
                        self.locks.release_sorted(t.footprint)
            sp.set(admitted=len(admitted), applied=applied,
                   epoch=self.epoch)
            if _trace.enabled():
                _obs_registry().observe("ingest.round_s",
                                        time.perf_counter() - t0)
            return applied

    def _run_round(self, admitted: list[Ticket]) -> int:
        base = self._head
        while True:
            live = [t for t in admitted if t.status != "aborted"]
            if not live:
                return 0
            fused = [op for t in live for op in t.ops]
            lanes = len(fused)
            pad = _next_pow2(lanes) if self.pad_lanes else lanes
            batch = make_op_batch(fused, lanes=pad, device=base.device)
            with _trace.span("ingest.fused_apply", lanes=lanes, pad=pad,
                             batches=len(live)):
                t0 = time.perf_counter()
                state, res = self._apply_with_grow(base, batch)
                _trace.fence(state)
            if _trace.enabled():
                _obs_registry().observe("ingest.fused_apply_s",
                                        time.perf_counter() - t0)
            # post-apply fault window: a batch dying here has its lanes in
            # the fused result, which is thrown away, never published
            died = [t for t in live if self._fault_fires(t, "apply")]
            if died:
                for t in died:
                    self.locks.release_sorted(t.footprint)
                    self._abort(t)
                continue                     # recompute from the same base
            now = self.clock()
            # the durability point: the round's record is fsync-durable
            # before the epoch flips and before any client is acked
            self._wal_commit(live, res, lanes, pad)
            with self._mutex:
                for t in live:
                    # part of the published prefix: appended before _publish
                    self.linearization.append(t.batch_id)
                self.stats.fused_calls += 1
                self.stats.coalesced_batches += len(live)
                self.stats.coalesce_max = max(self.stats.coalesce_max, len(live))
                self.stats.coalesce_lanes_max = max(
                    self.stats.coalesce_lanes_max, lanes)
                epoch = self._publish(state)
                if self.wal is not None:
                    self.stats.wal_records = self.wal.stats.records
                    self.stats.wal_bytes = self.wal.stats.bytes
                    self.stats.wal_append_s = self.wal.stats.append_s
            if self._crash_fires("post-publish-pre-ack"):
                # durable and published, never acked: recovery must
                # reproduce it bit for bit
                raise SimulatedCrash("post-publish-pre-ack", epoch)
            off = 0
            with self._mutex:
                for t in live:
                    t.results = res[off: off + t.lanes].copy()
                    off += t.lanes
                    t.status = "applied"
                    t.wait_s = max(0.0, now - t.enqueue_t)
                    self.stats.wait_s += t.wait_s
                    self.stats.wait_max_s = max(self.stats.wait_max_s, t.wait_s)
                    self.stats.applied += 1
                    self._queue.remove(t)
                self.stats.queue_depth = len(self._queue)
            for t in live:
                t.epoch = epoch
            self._maybe_checkpoint(epoch, state)
            return len(live)

    def _crash_fires(self, stage: str) -> bool:
        """Process-level crash stages, planned under the client ``"*"``."""
        return self.fault is not None and self.fault.should_die("*", stage)

    def _wal_commit(self, live: list[Ticket], res, lanes: int, pad: int
                    ) -> None:
        """Append and fsync the round's linearized record (DESIGN.md §16):
        every ``_publish`` and ticket ack of a round comes after it. Every
        number is made a Python int, and each op keeps its client's length,
        so the record's bytes are the JAX pool's. Without a WAL it only
        honours a planned ``wal-append`` / ``wal-fsync`` crash, so a
        schedule can kill an undurable pool."""
        epoch = self._slots[self._cur][0] + 1
        if self.wal is None:
            if (self._crash_fires("wal-append")
                    or self._crash_fires("wal-fsync")):
                raise SimulatedCrash("wal-append", epoch)
            return
        record = WalRecord(
            epoch=epoch,
            ops=[[int(x) for x in op] for t in live for op in t.ops],
            pad=int(pad),
            clients=[t.client_id for t in live],
            batch_ids=[t.batch_id for t in live],
            results=[int(x) for x in res[:lanes]],
            lanes=int(lanes),
        )
        if self._crash_fires("wal-append"):
            # kill mid-append: a torn, checksum-invalid frame hits disk;
            # reopening truncates it (the round was never acked)
            self.wal.append_torn(record)
            raise SimulatedCrash("wal-append", epoch)
        before_s = self.wal.stats.append_s
        with _trace.span("wal.append", epoch=epoch, lanes=lanes):
            self.wal.append(record)
        if _trace.enabled():
            _obs_registry().observe("wal.append_s",
                                    self.wal.stats.append_s - before_s)
        if self._crash_fires("wal-fsync"):
            # record durable, epoch never published, nobody acked: replay
            # must be idempotent about it
            raise SimulatedCrash("wal-fsync", epoch)

    def _maybe_checkpoint(self, epoch: int, state) -> None:
        """Cadence checkpoint + WAL truncation behind it (every epoch is
        covered by the checkpoint XOR the WAL tail)."""
        if self.ckpt is None or self.ckpt_every <= 0:
            return
        self._rounds_since_ckpt += 1
        if self._rounds_since_ckpt < self.ckpt_every:
            return
        self.checkpoint_now(epoch=epoch, state=state)

    def checkpoint_now(self, *, epoch: int | None = None, state=None) -> None:
        """Force one durable graph checkpoint of the published head (the
        cadence path, a server on shutdown, measurements)."""
        if self.ckpt is None:
            return
        if epoch is None or state is None:
            epoch, state = self.snapshot_epoch()
        kwargs = dict(epoch=epoch, state=state, ring=self.ring,
                      linearization=self.linearization,
                      epoch_log=self.epoch_log, next_batch_id=self._next_id,
                      index_stamp=self.index_stamp)
        if self._crash_fires("ckpt-mid-write"):
            # tmp dir fully written, rename never happens: recovery loads
            # the PREVIOUS published step
            self.ckpt.save_torn(**kwargs)
            raise SimulatedCrash("ckpt-mid-write", epoch)
        self.ckpt.save_graph(blocking=True, **kwargs)
        self._rounds_since_ckpt = 0
        with self._mutex:
            self.stats.ckpt_saves += 1
            if self.wal is not None:
                self.wal.truncate_through(epoch)
                self.stats.wal_truncations = self.wal.stats.truncations

    def flush(self) -> int:
        """Pump until the queue drains; returns total batches applied. The
        first queued ticket always admits, so every round with a non-empty
        queue applies or aborts at least one batch."""
        total = 0
        while True:
            before = self.queue_depth()
            if before == 0:
                return total
            total += self.pump()
            if self.queue_depth() >= before:  # pragma: no cover
                raise RuntimeError("ingest pool wedged: non-empty queue, "
                                   "zero admissions")
