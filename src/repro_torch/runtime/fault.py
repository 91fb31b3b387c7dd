"""Fault tolerance primitives for the port: heartbeats, straggler
detection, restart policy and the ingest pool's crash plan. The port's own
copy of ``repro.runtime.fault`` (which imports no JAX), kept line for line
so that the same plans drive both packages' pools.

  * Heartbeat: every worker ticks per step; a missing tick past ``timeout``
    marks the worker suspect, and the server enters its restart-from-
    recovery path.
  * StragglerDetector: per-step wall-time EWMA; steps slower than
    ``factor`` x EWMA are flagged.
  * FailurePolicy: exponential-backoff restart budget, the guard against
    crash loops.
  * FaultInjector: a deterministic kill plan for the multi-tenant ingest
    pool (runtime/ingest.py): a client batch can be made to die at a named
    admission stage; the pool must release its entity locks and keep the
    published state reachable by the completed batches alone
    (DESIGN.md §12).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


class SimulatedCrash(RuntimeError):
    """Raised by the ingest pool when a FaultInjector durability stage
    fires: models a process kill -9 at that exact point.  The pool is
    dead after this — the chaos harness recovers a fresh pool from the
    WAL + checkpoint and proves equivalence (DESIGN.md §16).

    ``stage`` names where the kill landed; ``epoch`` is the epoch the
    dying round WOULD have published (for harness assertions).
    """

    def __init__(self, stage: str, epoch: int = -1):
        super().__init__(f"simulated kill -9 at stage {stage!r}")
        self.stage = stage
        self.epoch = epoch


@dataclass
class Heartbeat:
    timeout_s: float = 30.0
    last: dict = field(default_factory=dict)

    def tick(self, worker: str, now: float | None = None):
        self.last[worker] = now if now is not None else time.time()

    def suspects(self, now: float | None = None) -> list[str]:
        now = now if now is not None else time.time()
        return [w for w, t in self.last.items() if now - t > self.timeout_s]


@dataclass
class StragglerDetector:
    factor: float = 3.0
    alpha: float = 0.1
    ewma_s: float | None = None
    flagged: int = 0

    def observe(self, step_s: float) -> bool:
        """Returns True if this step is a straggler."""
        if self.ewma_s is None:
            self.ewma_s = step_s
            return False
        is_straggler = step_s > self.factor * self.ewma_s
        if is_straggler:
            self.flagged += 1
        else:  # stragglers don't poison the baseline
            self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * step_s
        return is_straggler


@dataclass
class FaultInjector:
    """Deterministic crash plan for ingest admission (DESIGN.md §12).

    ``plan`` is a list of (client_id, stage) pairs; each entry kills that
    client's NEXT batch reaching that stage, once. Stages the ingest pool
    probes:

      * ``"admit"`` — after the batch's sorted entity locks are acquired,
        before its lanes enter the fused batch;
      * ``"apply"`` — after the fused ``apply_ops_fast`` result (which
        includes the batch's lanes) is computed, before it is published —
        the torn-write window the pool must recompute its way out of.

    The four DURABILITY stages (DESIGN.md §16) model a whole-process
    kill -9 instead of a single batch abort — the pool raises
    ``SimulatedCrash`` and the chaos harness must recover a fresh pool
    from checkpoint + WAL.  The client_id for these is the sentinel
    ``"*"`` (the crash is not attributable to one client):

      * ``"wal-append"`` — mid-append: a torn, checksum-invalid frame is
        on disk; recovery must truncate it (round unacked -> no loss);
      * ``"wal-fsync"`` — the record is fully durable but the epoch was
        never published and no client was acked; replay must be
        idempotent (the recovered log may extend the published prefix);
      * ``"ckpt-mid-write"`` — checkpoint tmp dir written, rename never
        happened; recovery must load the PREVIOUS checkpoint;
      * ``"post-publish-pre-ack"`` — record durable AND epoch published,
        but clients were never acked; recovery re-derives the identical
        state and the harness treats the round as durable-but-unacked.

    ``fired`` records consumed entries for assertions.  ``delays`` maps a
    plan entry to the number of probes of that (client, stage) pair to let
    PASS before it becomes eligible — ``delays[("*", "wal-fsync")] = 3``
    arms the kill at the 4th round reaching the fsync point, which is how
    the chaos suite sweeps a crash across every round of a schedule.
    """

    plan: list = field(default_factory=list)
    fired: list = field(default_factory=list)
    delays: dict = field(default_factory=dict)

    def should_die(self, client_id: str, stage: str) -> bool:
        key = (client_id, stage)
        if key in self.plan:
            left = self.delays.get(key, 0)
            if left > 0:
                self.delays[key] = left - 1
                return False
            self.plan.remove(key)
            self.fired.append(key)
            return True
        return False


@dataclass
class FailurePolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    restarts: int = 0

    def on_failure(self) -> float:
        """Returns backoff seconds, raises when the budget is exhausted."""
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError("restart budget exhausted; paging a human")
        return self.backoff_s * (2 ** (self.restarts - 1))
