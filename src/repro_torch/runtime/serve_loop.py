"""Batched serving loop co-hosting LM decode and graph queries, in PyTorch:
the port of ``repro.runtime.serve_loop`` (DESIGN.md §5(ii), §12, §13, §16).

The serving runtime owns two resources:
  * an LM decode engine (``serve``: prefill, then greedy ``decode_step``
    over a KV cache), on the dense-trunk models of ``repro_torch.models``;
  * a live concurrent graph (``GraphCoServer``): mutation batches are
    applied between decode steps, and GetPath queries run the paper's
    double-collect protocol against the latest published state, so queries
    never lock out mutations and vice versa.

With ``ingest=True`` many clients' batches go through the admission pool
(runtime/ingest.py), which publishes double-buffered epochs into a ring of
retained epochs (core/epochs.py): starved sessions resolve wait-free
there, and time-travel and epoch-diff queries read it. With ``index=True``
reachability answers come from the versioned 2-hop index when it is fresh,
or pinned at a retained epoch, and from the fused BFS double collect
otherwise.

With ``wal_dir=`` the pool writes ``<wal_dir>/wal.log`` and, every
``ckpt_every`` rounds, a graph checkpoint under ``<wal_dir>/ckpt``
(DESIGN.md §16): ``recover_now`` (and so ``handle_crash`` and the
heartbeat path) rebuilds the pool from checkpoint + WAL replay on the
server's device, carrying the resolved tickets and the index stamp
forward. Without a WAL it only un-pins, as the JAX server does.

A bare server (no ingest pool, no mesh) owns its store outright and
applies each batch into it (``core.ops.apply_ops_fast_``) instead of a
copy. Once it has handed its store out through ``state``, its next batch
goes to a copy, so a state a caller read stays as it was; a state
assigned to ``state`` becomes the server's store, which later batches
write (assign a clone to keep the original). A pool-backed or sharded
server keeps the functional engines: the pool's epochs are states that no
later batch writes.

The server creates its state on the card unless ``device`` names another.
With ``mesh=`` (a ``core.distributed.GraphMesh``) the state is a
``ShardedGraphState`` on that mesh (DESIGN.md §8): batches go through
``partition.apply_ops_fast``, sessions traverse with the sharded BFS, and
``get_path`` is a Q = 1 ``get_paths``, as in JAX. ``serve`` calls the
model eagerly under ``torch.inference_mode()`` where JAX jits its decode
step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import partition
from repro_torch.core.distributed import GraphMesh
from repro_torch.core.epochs import EpochEvictedError
from repro_torch.core.graph import (R_RECOVERING, R_TABLE_FULL, grow,
                                    make_graph, make_op_batch)
from repro_torch.core.ops import apply_ops_fast, apply_ops_fast_
from repro_torch.core.snapshot import (PathResult, get_path_session,
                                       get_paths_session)
from repro_torch.index import (build_index, index_fresh,
                               reach_counts_session, reach_session, refresh)
from repro_torch.models.model import params_device
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import StatsView
from repro_torch.obs.metrics import global_registry as _obs_registry
from repro_torch.runtime.fault import SimulatedCrash
from repro_torch.runtime.ingest import IngestPool, Ticket, batch_footprint
from repro_torch.runtime.recovery import (GraphCheckpointer, recover,
                                          resume_pool)
from repro_torch.runtime.wal import WriteAheadLog


class ServeStats(StatsView):
    """Per-``serve()``-call observability (DESIGN.md §12, §13, §14), stored
    under ``serve.<field>``: every field reports THIS call's activity —
    server-lifetime counters are snapshotted at serve start and reported
    as deltas, except the ``*_max`` high-water marks, which stay lifetime
    values (a max has no meaningful delta)."""

    _PREFIX = "serve"
    _SPEC = {
        "decode_steps": ("counter", 0),
        "decode_tokens": ("counter", 0),
        "graph_ops": ("counter", 0),
        "getpath_calls": ("counter", 0),
        "getpath_rounds": ("counter", 0),
        "getpath_starved": ("gauge", 0),  # sessions whose collects never matched
        "epoch_resolved": ("gauge", 0),   # starved sessions resolved wait-free
        "tt_calls": ("gauge", 0),         # time-travel queries served
        "tt_evicted": ("gauge", 0),       # time-travel past the window
        "epoch_diff_calls": ("gauge", 0),  # epoch-diff audit queries served
        "grow_events": ("gauge", 0),      # auto-grows during THIS serve call
        "index_hits": ("gauge", 0),       # index fast-path answers
        "index_misses": ("gauge", 0),     # fused-BFS fallbacks
        "index_refreshes": ("gauge", 0),  # index builds/refreshes
        # -- multi-tenant admission observability (DESIGN.md §12) -----------
        "ingest_batches": ("gauge", 0),       # client batches applied
        "ingest_fused_calls": ("gauge", 0),   # coalesced device applies
        "ingest_coalesce_max": ("gauge", 0),  # max batches in one fused call
        "ingest_retries": ("gauge", 0),       # rounds lost to conflicts
        "ingest_wait_s": ("gauge", 0.0),      # total enqueue->admission wait
        "ingest_wait_max_s": ("gauge", 0.0),
        "ingest_queue_depth_max": ("gauge", 0),
        "ingest_epochs": ("gauge", 0),        # snapshot epochs published
        # -- durability / degraded mode (DESIGN.md §16) ---------------------
        "degraded_reads": ("gauge", 0),       # reads served off the pinned epoch
        "rejected_writes": ("gauge", 0),      # R_RECOVERING typed rejections
        "recoveries": ("gauge", 0),           # restart-from-recovery completions
        "wall_s": ("gauge", 0.0),
    }


@dataclass
class TimeTravelResult:
    """Typed answer of the time-travel reachability endpoint. ``evicted``
    means the requested epoch left the retention window (``window`` says
    what is still addressable), never an exception at the surface."""

    epoch: int
    evicted: bool
    window: tuple
    found: list = field(default_factory=list)    # [bool] per pair
    paths: list = field(default_factory=list)    # [(found, keys)] per pair


@dataclass
class EpochDiffResult:
    """Typed answer of the epoch-diff endpoint: the rows (and the keys in
    them at each end) changed between two retained epochs; ``evicted`` when
    either endpoint left the window."""

    e_from: int
    e_to: int
    evicted: bool
    window: tuple
    rows: list = field(default_factory=list)
    keys_before: list = field(default_factory=list)
    keys_after: list = field(default_factory=list)


def _no_ring():
    return RuntimeError("GraphCoServer(ingest=True) required for "
                        "epoch-ring endpoints")


class GraphCoServer:
    """Owns the live graph and serves queries on it.

    A bare server applies each batch into its store, unless it has handed
    the store out through ``state`` since its last batch: then the batch
    goes to a copy, which becomes the store. ``auto_grow`` (default on):
    any R_TABLE_FULL lane doubles the capacity and replays the whole batch
    on the grown pre-batch state, so ``submit`` never surfaces slot
    exhaustion (only a batch that could overflow answers R_TABLE_FULL, and
    the engine applies such a batch to a copy, so the pre-batch state is
    still there). ``ingest=True`` attaches the admission pool:
    ``submit_client`` enqueues per-client batches, ``pump``/``flush`` run
    admission rounds, and ``state`` is the pool's published epoch.
    ``index=True`` keeps a versioned 2-hop reachability index, refreshed by
    ``index_tick``; it is an accelerator, never a consistency dependency.
    """

    def __init__(self, capacity: int = 256, query_engine: str = "fused",
                 mesh=None, auto_grow: bool = True, index: bool = False,
                 index_landmarks: int | None = None, ingest: bool = False,
                 max_inflight: int = 8, max_coalesce_lanes: int = 256,
                 fault=None, on_conflict: str | None = None,
                 retain_epochs: int = 64, wal_dir: str | None = None,
                 ckpt_every: int = 0, heartbeat=None, failure_policy=None,
                 device=None):
        if mesh is not None and not isinstance(mesh, GraphMesh):
            raise TypeError(f"GraphCoServer(mesh=) takes a GraphMesh, got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.auto_grow = auto_grow
        self.query_engine = query_engine
        self.grow_events = 0
        self._submits = 0               # submit calls: a traced batch's seq
        self.index_enabled = bool(index)
        self.index_landmarks = index_landmarks
        self.index = None
        self.index_hits = 0
        self.index_misses = 0
        self.index_refreshes = 0
        # wait-free snapshot observability (lifetime counters)
        self.getpath_starved = 0
        self.epoch_resolved = 0
        self.tt_calls = 0
        self.tt_evicted = 0
        self.epoch_diff_calls = 0
        # degraded mode: reads pin to the last published epoch and writes
        # get typed R_RECOVERING rejections while the server recovers
        self.degraded = False
        self.degraded_reads = 0
        self.rejected_writes = 0
        self.recoveries = 0
        self.heartbeat = heartbeat
        self.failure_policy = failure_policy
        self._pinned = None            # (epoch, state) while degraded
        self._capacity = int(capacity)   # seats a recovery with no checkpoint
        self._handed_out = False       # ``state`` returned the live store
        self._wal_dir = wal_dir
        if mesh is not None:
            self._state = partition.shard_state(
                mesh, make_graph(capacity, device=mesh.device))
        else:
            self._state = make_graph(capacity, device=device)
        self.pool = None
        if ingest:
            def bump_grow():
                self.grow_events += 1

            wal = ckpt = None
            if wal_dir is not None:
                wal = WriteAheadLog(f"{wal_dir}/wal.log")
                ckpt = GraphCheckpointer(f"{wal_dir}/ckpt")
            self.pool = IngestPool(
                self._state, mesh=mesh, auto_grow=auto_grow, max_inflight=max_inflight,
                max_coalesce_lanes=max_coalesce_lanes, fault=fault,
                on_grow=bump_grow, retain_epochs=retain_epochs, wal=wal,
                ckpt=ckpt, ckpt_every=ckpt_every)
        # a pool-backed server resolves starved sessions wait-free against
        # its epoch ring; a bare server keeps the capped retry
        self.on_conflict = on_conflict if on_conflict is not None else (
            "epoch" if self.pool is not None else "retry")

    @property
    def state(self):
        """Latest published state (the pool's double-buffered epoch when
        ingesting); while degraded, the epoch published before the
        failure. A bare server's next batch leaves the state returned here
        as it is."""
        st = self._published()
        if st is self._state:
            self._handed_out = True
        return st

    @state.setter
    def state(self, value):
        if self.pool is not None:
            raise AttributeError(
                "state is pool-owned under multi-tenant ingestion; "
                "mutate through submit()/submit_client()")
        self._state = value
        self._handed_out = False

    def _published(self):
        """``state`` as the server's own calls read it: the store is not
        handed out."""
        if self.degraded and self._pinned is not None:
            return self._pinned[1]
        return self.pool.snapshot() if self.pool is not None else self._state

    def _apply(self, state, batch, owned: bool):
        if self.mesh is not None:
            return partition.apply_ops_fast(state, batch)
        # ``submit`` calls this only without a pool: a store that no caller
        # holds takes the batch in place
        if owned:
            return apply_ops_fast_(state, batch)
        return apply_ops_fast(state, batch)

    def _grow(self, state, new_capacity: int):
        if self.mesh is not None:
            return partition.grow(state, new_capacity)
        return grow(state, new_capacity)

    def submit(self, ops: list) -> np.ndarray:
        """Apply one batch of (opcode, k1[, k2[, expect]]) tuples in lane
        order; returns its result codes. Traced as one ``serve.submit``
        span (``seq`` counts the server's calls)."""
        self._submits += 1
        with _trace.span("serve.submit", lanes=len(ops), seq=self._submits):
            if self.degraded:
                # typed rejection: every lane answers R_RECOVERING
                self.rejected_writes += 1
                with _trace.span("serve.reject_write", lanes=len(ops)):
                    return np.full((len(ops),), R_RECOVERING, np.int32)
            if self.pool is not None:
                # one anonymous client on the pool, drained: one
                # linearization log shared with every concurrent client
                ticket = self.pool.submit("_direct", ops)
                self.pool.flush()
                return np.asarray(ticket.results)
            base = self._state
            with _trace.span("serve.make_batch", lanes=len(ops)):
                batch = make_op_batch(ops, device=base.device)
            state, res = self._apply(base, batch, not self._handed_out)
            with _trace.span("serve.codes_to_host"):
                res = res.cpu().numpy()
            while self.auto_grow and (res == R_TABLE_FULL).any():
                if state is base:
                    raise RuntimeError(
                        "a batch applied in place answered R_TABLE_FULL: "
                        "no pre-batch state is left to replay on")
                # discard the starved application, grow the PRE-batch state
                # and replay the whole batch: one clean lane-order
                # linearization
                with _trace.span("serve.grow", capacity=2 * state.capacity):
                    base = self._grow(base, 2 * state.capacity)
                    self.grow_events += 1
                    state, res = self._apply(base, batch, True)
                    with _trace.span("serve.codes_to_host"):
                        res = res.cpu().numpy()
            self._state, self._handed_out = state, False
            return res

    # -- multi-tenant admission surface (DESIGN.md §12) ---------------------
    def submit_client(self, client_id: str, ops: list):
        """Enqueue one client's mutation batch; returns its ``Ticket``
        (requires ``ingest=True``)."""
        if self.pool is None:
            raise RuntimeError("GraphCoServer(ingest=True) required for "
                               "multi-tenant submission")
        if self.degraded:
            # typed rejection ticket: never enqueued, resolved at once
            footprint, exclusive = batch_footprint(ops)
            self.rejected_writes += 1
            with _trace.span("serve.reject_write", lanes=len(ops)):
                return Ticket(-1, str(client_id), list(ops), footprint,
                              exclusive, self.pool.clock(),
                              status="rejected",
                              results=np.full((len(ops),), R_RECOVERING,
                                              np.int32))
        return self.pool.submit(client_id, ops)

    def pump(self) -> int:
        """One admission round of the ingest pool."""
        return self.pool.pump() if self.pool is not None else 0

    def flush(self) -> int:
        """Drain the ingest queue."""
        return self.pool.flush() if self.pool is not None else 0

    # -- degraded mode (DESIGN.md §16) --------------------------------------
    def worker_tick(self, worker: str = "ingest", now: float | None = None):
        """Heartbeat tick for an in-process worker."""
        if self.heartbeat is not None:
            self.heartbeat.tick(worker, now)

    def check_health(self, now: float | None = None) -> list:
        """Suspect scan: a worker past the heartbeat timeout triggers the
        restart-from-recovery path. Returns the suspects."""
        if self.heartbeat is None:
            return []
        suspects = self.heartbeat.suspects(now)
        if suspects and not self.degraded:
            self.handle_crash()
            # the restarted worker is live again
            for w in suspects:
                self.heartbeat.tick(w, now)
        return suspects

    def enter_degraded(self) -> None:
        """Pin the last published epoch and start rejecting writes."""
        if self.pool is not None:
            self._pinned = self.pool.snapshot_epoch()
        else:
            self._pinned = (0, self._state)
        self.degraded = True
        if _trace.enabled():
            _obs_registry().set("serve.degraded", 1)
            _trace.counter("serve.degraded", 1)

    def recover_now(self) -> None:
        """Restart-from-recovery: rebuild the pool from checkpoint + WAL
        replay on the server's device, with the dead pool's settings;
        reads un-pin, writes are accepted again. Without a WAL there is
        nothing durable to recover from, so it only un-pins."""
        if self.pool is None or self._wal_dir is None:
            self.degraded = False
            self._pinned = None
            return
        with _trace.span("serve.recover"):
            old = self.pool
            old.wal.close()
            wal = WriteAheadLog(f"{self._wal_dir}/wal.log")
            rec = recover(old.ckpt, wal, capacity=self._capacity,
                          mesh=self.mesh, auto_grow=old.auto_grow,
                          retain_epochs=old.ring.retain,
                          device=self._state.device)
            self.pool = resume_pool(
                rec, mesh=self.mesh, auto_grow=old.auto_grow, max_inflight=old.max_inflight,
                max_coalesce_lanes=old.max_coalesce_lanes, fault=old.fault,
                on_grow=old.on_grow, retain_epochs=old.ring.retain, wal=wal,
                ckpt=old.ckpt, ckpt_every=old.ckpt_every)
            # carry forward what recovery cannot know: tickets resolved
            # before the crash (clients hold references to them)
            self.pool.tickets.update(old.tickets)
            self.pool.index_stamp = old.index_stamp
        self.degraded = False
        self._pinned = None
        self.recoveries += 1
        if _trace.enabled():
            _obs_registry().set("serve.degraded", 0)
            _trace.counter("serve.degraded", 0)

    def handle_crash(self, exc=None) -> float:
        """One suspect/crash -> degrade -> backoff -> recover cycle; returns
        the backoff the FailurePolicy budgeted (0.0 without one) and raises
        once the restart budget is exhausted."""
        self.enter_degraded()
        wait = 0.0
        if self.failure_policy is not None:
            wait = self.failure_policy.on_failure()
        self.recover_now()
        return wait

    def _fetch_epoch(self):
        """(epoch, state) pin source for wait-free resolution: the pool's
        published slot when ingesting (the frozen pre-failure epoch while
        degraded), None otherwise."""
        if self.degraded and self._pinned is not None:
            return lambda: self._pinned
        return self.pool.snapshot_epoch if self.pool is not None else None

    def _note_session(self, stats: dict):
        if stats.get("starved"):
            self.getpath_starved += 1
        if stats.get("resolved") == "epoch":
            self.epoch_resolved += 1

    def get_path(self, k: int, l: int, max_rounds: int = 64) -> PathResult:
        if self.mesh is not None:
            # the mesh path: a Q = 1 batch session (it counts its own
            # degraded read and starvation), as in JAX
            out, rounds = self.get_paths([(k, l)], max_rounds=max_rounds)
            found, keys = out[0]
            pad = np.full((self._published().capacity,), -1, np.int32)
            pad[:len(keys)] = keys
            dev = self._published().device
            return PathResult(
                torch.tensor(found, device=dev),
                torch.tensor(len(keys), dtype=torch.int32, device=dev),
                torch.from_numpy(pad).to(dev),
                torch.tensor(rounds, dtype=torch.int32, device=dev),
                torch.tensor(False, device=dev))
        if self.degraded:
            self.degraded_reads += 1
        pr = get_path_session(self._published, k, l,
                              max_rounds=max_rounds,
                              on_conflict=self.on_conflict,
                              fetch_epoch=self._fetch_epoch())
        if bool(pr.starved):
            self.getpath_starved += 1
            if self.on_conflict == "epoch":
                self.epoch_resolved += 1
        return pr

    def get_paths(self, pairs: list, max_rounds: int = 64):
        """Batched reachability: Q queries under ONE shared double collect
        on the fused multi-source BFS; a session at its retry budget follows
        ``on_conflict``. Returns ([(found, keys)] per pair, rounds)."""
        if self.degraded and self._pinned is not None:
            self.degraded_reads += 1
        st: dict = {}
        out, rounds = get_paths_session(self._published, pairs,
                                        max_rounds=max_rounds,
                                        engine=self.query_engine,
                                        on_conflict=self.on_conflict,
                                        fetch_epoch=self._fetch_epoch(),
                                        stats=st)
        self._note_session(st)
        return out, rounds

    # -- retained-epoch endpoints (DESIGN.md §13) --------------------------
    def epoch_window(self) -> tuple:
        """(oldest addressable, newest published) epoch of the ring."""
        if self.pool is None:
            raise _no_ring()
        return self.pool.epoch_window()

    def get_reach_at(self, pairs: list, epoch: int) -> TimeTravelResult:
        """Time-travel reachability, "was u->w reachable at epoch e?": one
        collect over the ring's reconstruction of that epoch (a frozen
        state). Epochs past the window give a typed evicted result."""
        if self.pool is None:
            raise _no_ring()
        self.tt_calls += 1
        try:
            state_e = self.pool.state_at(epoch)
        except EpochEvictedError as err:
            self.tt_evicted += 1
            return TimeTravelResult(int(epoch), True, err.window)
        out, _rounds = get_paths_session(lambda: state_e, pairs,
                                         engine=self.query_engine)
        return TimeTravelResult(int(epoch), False, self.pool.epoch_window(),
                                [f for f, _ in out], out)

    def epoch_diff(self, e1: int, e2: int) -> EpochDiffResult:
        """Which rows (and keys) changed between epochs e1 and e2, read off
        the retained records; a typed evicted result past the window."""
        if self.pool is None:
            raise _no_ring()
        self.epoch_diff_calls += 1
        try:
            d = self.pool.epoch_diff(e1, e2)
        except EpochEvictedError as err:
            return EpochDiffResult(int(e1), int(e2), True, err.window)
        return EpochDiffResult(d.e_from, d.e_to, False,
                               self.pool.epoch_window(),
                               [int(r) for r in d.rows],
                               [int(k) for k in d.keys_before],
                               [int(k) for k in d.keys_after])

    # -- reachability index surface (DESIGN.md §9) -------------------------
    def index_tick(self) -> bool:
        """Build or refresh the index if enabled and stale; True when one
        ran. The refreshed index lands as a reference swap."""
        if not self.index_enabled:
            return False
        if self.index is None:
            self.index = build_index(self._published(),
                                     self.index_landmarks)
        elif not index_fresh(self.index, self._published()):
            self.index, _ = refresh(self.index, self._published())
        else:
            return False
        self.index_refreshes += 1
        if self.pool is not None:
            self.pool.index_stamp = {"epoch": int(self.pool.epoch),
                                     "refreshes": int(self.index_refreshes)}
        return True

    def get_reach(self, pairs: list, max_rounds: int = 64):
        """Batched reachability without paths: index-served when fresh (or
        pinned at a retained epoch), the fused BFS double collect otherwise.
        Returns a ``ReachSessionResult``."""
        res = reach_session(self._published,
                            self.index if self.index_enabled else None,
                            pairs, engine=self.query_engine,
                            max_rounds=max_rounds,
                            on_conflict=self.on_conflict,
                            fetch_epoch=self._fetch_epoch(),
                            ring=self.pool.ring if self.pool is not None
                            else None)
        if self.degraded:
            res.degraded = True
            self.degraded_reads += 1
        if self.index_enabled:   # a server without an index has no misses
            self.index_hits += res.from_index
            self.index_misses += res.fellback
        if res.starved:
            self.getpath_starved += 1
            if self.on_conflict == "epoch":
                self.epoch_resolved += 1
        return res

    def get_reach_counts(self, keys: list) -> np.ndarray:
        """|reachable set| per source key: from the index when fresh, one
        closure-mode multi-BFS otherwise."""
        if self.degraded:
            self.degraded_reads += 1
        counts, from_index = reach_counts_session(
            self._published, self.index if self.index_enabled else None,
            keys)
        if self.index_enabled:
            if from_index:
                self.index_hits += len(counts)
            else:
                self.index_misses += len(counts)
        return counts

    # -- metrics endpoint (DESIGN.md §14) ----------------------------------
    def get_metrics(self) -> dict:
        """One flat name -> value snapshot: the server's lifetime counters
        (``server.*``), the pool's registry (``ingest.*``) and ring window,
        and the process-global tracing metrics. Histograms are {count, sum,
        min, max} sub-dicts."""
        out = {
            "server.grow_events": self.grow_events,
            "server.index_hits": self.index_hits,
            "server.index_misses": self.index_misses,
            "server.index_refreshes": self.index_refreshes,
            "server.getpath_starved": self.getpath_starved,
            "server.epoch_resolved": self.epoch_resolved,
            "server.tt_calls": self.tt_calls,
            "server.tt_evicted": self.tt_evicted,
            "server.epoch_diff_calls": self.epoch_diff_calls,
            "server.degraded": int(self.degraded),
            "server.degraded_reads": self.degraded_reads,
            "server.rejected_writes": self.rejected_writes,
            "server.recoveries": self.recoveries,
        }
        if self.pool is not None:
            out.update(self.pool.registry.snapshot())
            lo, hi = self.pool.epoch_window()
            out["ring.window_lo"] = int(lo)
            out["ring.window_hi"] = int(hi)
        out.update(_obs_registry().snapshot())
        return out


def serve(model, params, prompts: np.ndarray, *, max_new_tokens: int,
          cache_len: int, graph: GraphCoServer | None = None,
          mutator=None, query_stream=None, clients=None,
          temperature: float = 0.0):
    """Greedy batched decoding with interleaved graph traffic.

    prompts: int32 [B, P]. Returns (generated int32 [B, max_new_tokens],
    stats). ``temperature`` is accepted and unused, as in JAX: decoding is
    greedy.

    ``clients`` (requires ``GraphCoServer(ingest=True)``) is the multi-
    tenant mutation stream: a callable ``step -> [(client_id, ops), ...]``.
    Each step's batches are enqueued and one admission round runs —
    non-conflicting batches coalesce into one fused apply while the read
    stream keeps hitting the last published snapshot epoch (DESIGN.md §12);
    the queue is drained after the last decode step.
    """
    t0 = time.time()
    stats = ServeStats()
    # server counters are lifetime-cumulative; ServeStats reports per-serve
    # deltas, so every lifetime counter gets a start-of-serve snapshot
    grow0 = graph.grow_events if graph is not None else 0
    idx0 = ((graph.index_hits, graph.index_misses, graph.index_refreshes)
            if graph is not None else (0, 0, 0))
    ring0 = ((graph.getpath_starved, graph.epoch_resolved, graph.tt_calls,
              graph.tt_evicted, graph.epoch_diff_calls)
             if graph is not None else (0, 0, 0, 0, 0))
    rec0 = ((graph.degraded_reads, graph.rejected_writes, graph.recoveries)
            if graph is not None else (0, 0, 0))
    pool = graph.pool if graph is not None else None
    if clients is not None and pool is None:
        raise RuntimeError("clients= stream requires GraphCoServer(ingest=True)")
    ing0 = ((pool.stats.applied, pool.stats.fused_calls, pool.stats.retries,
             pool.stats.wait_s, pool.stats.epochs)
            if pool is not None else (0, 0, 0, 0.0, 0))
    b, p = prompts.shape
    dev = params_device(params)
    _session = _trace.span("serve.session", batch=b,
                           max_new_tokens=max_new_tokens)
    _session.__enter__()
    with _trace.span("serve.prefill", batch=b, prompt_len=p), \
            torch.inference_mode():
        tokens = torch.from_numpy(np.asarray(prompts, np.int32)).to(dev)
        last, caches = model.prefill(params, {"tokens": tokens})
        caches = model.cache_from_prefill(caches, cache_len)
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        _trace.fence(last)

    out = np.zeros((b, max_new_tokens), np.int32)
    for i in range(max_new_tokens):
        out[:, i] = tok.cpu().numpy()
        # interleave graph traffic between decode steps (non-blocking
        # co-serving)
        if graph is not None and mutator is not None:
            ops = mutator(i)
            if ops:
                graph.submit(ops)
                stats.graph_ops += len(ops)
        if graph is not None and clients is not None:
            for client_id, ops in clients(i) or ():
                if ops:
                    graph.submit_client(client_id, ops)
                    stats.graph_ops += len(ops)
            # one admission round per decode step (DESIGN.md §12)
            try:
                graph.pump()
            except SimulatedCrash:
                # worker died mid-round: degrade, spend one restart-budget
                # slot, recover (DESIGN.md §16); past the budget the
                # FailurePolicy raises, and that propagates
                graph.handle_crash()
        if graph is not None:
            # heartbeat: the ingest worker ticks every decode step; a
            # missing tick past the timeout trips check_health into the
            # same restart-from-recovery path (DESIGN.md §16)
            graph.worker_tick("ingest")
            graph.check_health()
            # background index refresh between decode steps: queries racing
            # a stale index fall back to BFS, mutations never wait
            graph.index_tick()
        if graph is not None and query_stream is not None:
            q = query_stream(i)
            if q is not None and len(q) > 0:
                # a batch is a sequence OF (k, l) pairs (list/tuple/ndarray);
                # a lone pair — any length-2 sequence of scalars — stays on
                # the single-query path. Scalars have no __len__.
                if hasattr(q[0], "__len__"):
                    batch_pairs = [(int(x[0]), int(x[1])) for x in q]
                    stats.getpath_calls += len(q)
                    if graph.index_enabled:
                        res = graph.get_reach(batch_pairs)
                        # rounds are charged per pair, and only to the
                        # pairs that took the BFS fallback session
                        stats.getpath_rounds += res.rounds * res.fellback
                    else:
                        _, rounds = graph.get_paths(batch_pairs)
                        # every pair shares the one session's double collect
                        stats.getpath_rounds += rounds * len(q)
                elif graph.index_enabled:
                    res = graph.get_reach([(int(q[0]), int(q[1]))])
                    stats.getpath_calls += 1
                    stats.getpath_rounds += res.rounds
                else:
                    res = graph.get_path(int(q[0]), int(q[1]))
                    stats.getpath_calls += 1
                    stats.getpath_rounds += int(res.rounds)
        with _trace.span("serve.decode_step", step=i), torch.inference_mode():
            tok_logits, caches = model.decode_step(params, caches, tok, p + i)
            tok = torch.argmax(tok_logits, dim=-1).to(torch.int32)
            _trace.fence(tok)
        stats.decode_steps += 1
        stats.decode_tokens += b
    if pool is not None:
        try:
            graph.flush()                    # drain whatever is still queued
        except SimulatedCrash:
            graph.handle_crash()
            graph.flush()
        pool = graph.pool                    # recovery may have replaced it
        stats.ingest_batches = pool.stats.applied - ing0[0]
        stats.ingest_fused_calls = pool.stats.fused_calls - ing0[1]
        stats.ingest_retries = pool.stats.retries - ing0[2]
        stats.ingest_wait_s = pool.stats.wait_s - ing0[3]
        stats.ingest_epochs = pool.stats.epochs - ing0[4]
        # high-water marks are lifetime values
        stats.ingest_coalesce_max = pool.stats.coalesce_max
        stats.ingest_wait_max_s = pool.stats.wait_max_s
        stats.ingest_queue_depth_max = pool.stats.queue_depth_max
    if graph is not None:
        stats.grow_events = graph.grow_events - grow0
        stats.index_hits = graph.index_hits - idx0[0]
        stats.index_misses = graph.index_misses - idx0[1]
        stats.index_refreshes = graph.index_refreshes - idx0[2]
        stats.getpath_starved = graph.getpath_starved - ring0[0]
        stats.epoch_resolved = graph.epoch_resolved - ring0[1]
        stats.tt_calls = graph.tt_calls - ring0[2]
        stats.tt_evicted = graph.tt_evicted - ring0[3]
        stats.epoch_diff_calls = graph.epoch_diff_calls - ring0[4]
        stats.degraded_reads = graph.degraded_reads - rec0[0]
        stats.rejected_writes = graph.rejected_writes - rec0[1]
        stats.recoveries = graph.recoveries - rec0[2]
    stats.wall_s = time.time() - t0
    _session.set(decode_steps=stats.decode_steps,
                 getpath_calls=stats.getpath_calls,
                 graph_ops=stats.graph_ops)
    _session.__exit__(None, None, None)
    return out, stats
