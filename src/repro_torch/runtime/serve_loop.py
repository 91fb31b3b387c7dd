"""``GraphCoServer``'s graph endpoints, in PyTorch: the port of the graph
half of ``repro.runtime.serve_loop`` (DESIGN.md §5(ii), §12, §13, §16).

The server owns a live concurrent graph: mutation batches are applied
between queries, and GetPath queries run the paper's double-collect
protocol against the latest published state, so queries never lock out
mutations and vice versa. With ``ingest=True`` many clients' batches go
through the admission pool (runtime/ingest.py), which publishes
double-buffered epochs into a ring of retained epochs (core/epochs.py):
starved sessions resolve wait-free there, and time-travel and epoch-diff
queries read it. With ``index=True`` reachability answers come from the
versioned 2-hop index when it is fresh, or pinned at a retained epoch, and
from the fused BFS double collect otherwise.

With ``wal_dir=`` the pool writes ``<wal_dir>/wal.log`` and, every
``ckpt_every`` rounds, a graph checkpoint under ``<wal_dir>/ckpt``
(DESIGN.md §16): ``recover_now`` (and so ``handle_crash`` and the
heartbeat path) rebuilds the pool from checkpoint + WAL replay on the
server's device, carrying the resolved tickets and the index stamp
forward. Without a WAL it only un-pins, as the JAX server does.

The server creates its state on the card unless ``device`` names another.
With ``mesh=`` (a ``core.distributed.GraphMesh``) the state is a
``ShardedGraphState`` on that mesh (DESIGN.md §8): batches go through
``partition.apply_ops_fast``, sessions traverse with the sharded BFS, and
``get_path`` is a Q = 1 ``get_paths``, as in JAX. Not ported yet: the LM
``serve()`` loop (ROADMAP.md queue A12). ``ServeStats`` is ported so that
its metric names exist.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import partition
from repro_torch.core.distributed import GraphMesh
from repro_torch.core.epochs import EpochEvictedError
from repro_torch.core.graph import (R_RECOVERING, R_TABLE_FULL, grow,
                                    make_graph, make_op_batch)
from repro_torch.core.ops import apply_ops_fast
from repro_torch.core.snapshot import (PathResult, get_path_session,
                                       get_paths_session)
from repro_torch.index import (build_index, index_fresh,
                               reach_counts_session, reach_session, refresh)
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import StatsView
from repro_torch.obs.metrics import global_registry as _obs_registry
from repro_torch.runtime.ingest import IngestPool, Ticket, batch_footprint
from repro_torch.runtime.recovery import (GraphCheckpointer, recover,
                                          resume_pool)
from repro_torch.runtime.wal import WriteAheadLog


class ServeStats(StatsView):
    """Per-``serve()``-call observability (DESIGN.md §12, §13, §14), stored
    under ``serve.<field>``. The LM ``serve()`` loop that fills it waits
    for ROADMAP.md queue A12; the view is here so its names exist."""

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
    """Owns the live graph; publishes functional snapshots to queries.

    ``auto_grow`` (default on): any R_TABLE_FULL lane doubles the capacity
    and replays the whole batch on the grown pre-batch state, so ``submit``
    never surfaces slot exhaustion. ``ingest=True`` attaches the admission
    pool: ``submit_client`` enqueues per-client batches, ``pump``/``flush``
    run admission rounds, and ``state`` is the pool's published epoch.
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
        failure."""
        if self.degraded and self._pinned is not None:
            return self._pinned[1]
        return self.pool.snapshot() if self.pool is not None else self._state

    @state.setter
    def state(self, value):
        if self.pool is not None:
            raise AttributeError(
                "state is pool-owned under multi-tenant ingestion; "
                "mutate through submit()/submit_client()")
        self._state = value

    def _apply(self, state, batch):
        if self.mesh is not None:
            return partition.apply_ops_fast(state, batch)
        return apply_ops_fast(state, batch)

    def _grow(self, state, new_capacity: int):
        if self.mesh is not None:
            return partition.grow(state, new_capacity)
        return grow(state, new_capacity)

    def submit(self, ops: list) -> np.ndarray:
        if self.degraded:
            # typed rejection: every lane answers R_RECOVERING
            self.rejected_writes += 1
            with _trace.span("serve.reject_write", lanes=len(ops)):
                return np.full((len(ops),), R_RECOVERING, np.int32)
        if self.pool is not None:
            # one anonymous client on the pool, drained: one linearization
            # log shared with every concurrent client
            ticket = self.pool.submit("_direct", ops)
            self.pool.flush()
            return np.asarray(ticket.results)
        base = self.state                    # pre-batch snapshot (functional)
        batch = make_op_batch(ops, device=base.device)
        state, res = self._apply(base, batch)
        res = res.cpu().numpy()
        while self.auto_grow and (res == R_TABLE_FULL).any():
            # discard the starved application, grow the PRE-batch state and
            # replay the whole batch: one clean lane-order linearization
            base = self._grow(base, 2 * state.capacity)
            self.grow_events += 1
            state, res = self._apply(base, batch)
            res = res.cpu().numpy()
        self.state = state
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
            pad = np.full((self.state.capacity,), -1, np.int32)
            pad[:len(keys)] = keys
            dev = self.state.device
            return PathResult(
                torch.tensor(found, device=dev),
                torch.tensor(len(keys), dtype=torch.int32, device=dev),
                torch.from_numpy(pad).to(dev),
                torch.tensor(rounds, dtype=torch.int32, device=dev),
                torch.tensor(False, device=dev))
        if self.degraded:
            self.degraded_reads += 1
        pr = get_path_session(lambda: self.state, k, l,
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
        out, rounds = get_paths_session(lambda: self.state, pairs,
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
            self.index = build_index(self.state, self.index_landmarks)
        elif not index_fresh(self.index, self.state):
            self.index, _ = refresh(self.index, self.state)
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
        res = reach_session(lambda: self.state,
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
            lambda: self.state, self.index if self.index_enabled else None,
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
