"""Crash recovery for the serving stack, in PyTorch: checkpoint + WAL
replay, the port of ``repro.runtime.recovery`` (DESIGN.md §16).

``GraphCheckpointer`` wraps the generic ``Checkpointer`` with the graph's
tree: the six ``GraphState`` fields (both packed adjacency mirrors
included), every retained ``EpochRing`` record, and the pool's logical
registers (linearization log, epoch -> prefix map, ticket id counter,
index freshness stamp) as JSON extra. The leaves carry the JAX package's
dtypes: the two word matrices as uint32 (their int32 bits viewed), ``valive``
bool, the rest int32, so either package restores the other's checkpoint
into a working state. The ring makes the leaf count vary per checkpoint,
hence ``Checkpointer.restore_raw``.

``recover`` rebuilds the pre-crash published prefix: load the newest
checkpoint onto the card (unless ``device`` names another), then replay
every WAL record with a newer epoch through the port's ``apply_ops_fast``
(never ``apply_ops``: the two engines answer opcodes >= 7 differently),
with the record's lane padding and the pool's auto-grow discipline, so
the recovered state is bit-identical, not merely equivalent. Replay is
idempotent: records at or below the checkpointed epoch are skipped (the
``wal-fsync`` crash can leave a durable record the checkpoint already
covers), and each record's stored result codes are cross-checked against
the replayed ones (one copy of the results to the host per record): a
mismatch means log/checkpoint corruption and raises ``RecoveryError``
rather than silently serving wrong state. Replay is functional: no state
the ring holds is written in place.

``resume_pool`` turns a ``Recovered`` into a live ``IngestPool`` whose
published epoch, linearization log and epoch ring continue exactly where
the dead process stopped. Sharded states (``mesh=``) wait for ROADMAP.md
queue A10.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.core.epochs import EpochRing
from repro_torch.core.graph import (R_TABLE_FULL, GraphState, grow,
                                    make_graph, make_op_batch,
                                    resolve_device)
from repro_torch.core.ops import apply_ops_fast
from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import global_registry as _obs_registry
from repro_torch.runtime.ingest import IngestPool
from repro_torch.runtime.wal import WriteAheadLog

_STATE_FIELDS = ("vkey", "valive", "vver", "ecnt", "adj_packed",
                 "adj_in_packed")
_WORD_FIELDS = ("adj_packed", "adj_in_packed")


class RecoveryError(RuntimeError):
    """Checkpoint/WAL contents contradict each other: refuse to serve."""


@dataclass
class Recovered:
    """Everything ``recover`` reconstructed from disk."""

    state: GraphState | None
    epoch: int
    linearization: list = field(default_factory=list)
    epoch_log: dict = field(default_factory=dict)
    next_batch_id: int = 0
    ring: EpochRing = field(default_factory=EpochRing)
    replayed_rounds: int = 0          # WAL records applied on top of the ckpt
    skipped_records: int = 0          # idempotence: records the ckpt covered
    ckpt_step: int | None = None      # checkpoint epoch loaded (None = fresh)
    index_stamp: dict | None = None
    restore_s: float = 0.0
    # wall seconds by part: "ckpt_load" (files to host arrays), "to_device"
    # (the six state leaves), "ring_load", "replay" (all records)
    parts: dict = field(default_factory=dict)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_leaf(state: GraphState, name: str) -> np.ndarray:
    """One state field as the host array the JAX package checkpoints (its
    own copy: the writer thread may run after the caller moves on)."""
    a = getattr(state, name).to("cpu", copy=True).numpy()
    return a.view(np.uint32) if name in _WORD_FIELDS else a


def _state_from_leaves(leaves, dev) -> GraphState:
    """The six checkpointed leaves (either package's) as a state on
    ``dev``; the word matrices' uint32 bits viewed as int32."""
    out = []
    for name, leaf in zip(_STATE_FIELDS, leaves, strict=True):
        a = np.ascontiguousarray(leaf)
        if name in _WORD_FIELDS:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a).to(dev))
    return GraphState(*out)


class GraphCheckpointer:
    """Graph-aware snapshots at a round cadence, truncating the WAL behind
    them (the checkpoint-truncation invariant: every epoch is covered by
    the checkpoint XOR the WAL tail, never neither)."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.inner = Checkpointer(directory, keep=keep)

    def _leaves_manifest(self, *, epoch, state, ring, linearization,
                         epoch_log, next_batch_id, index_stamp):
        leaves = [_host_leaf(state, f) for f in _STATE_FIELDS]
        ring_leaves, ring_meta = ring.dump()
        extra = {
            "kind": "graph",
            "epoch": int(epoch),
            "capacity": int(state.capacity),
            "n_state_leaves": len(_STATE_FIELDS),
            "ring_meta": ring_meta,
            "linearization": [int(b) for b in linearization],
            "epoch_log": {str(k): int(v) for k, v in epoch_log.items()},
            "next_batch_id": int(next_batch_id),
            "index_stamp": index_stamp,
        }
        return leaves + ring_leaves, extra

    def save_graph(self, *, epoch, state, ring, linearization, epoch_log,
                   next_batch_id, index_stamp=None, blocking=True) -> None:
        """One durable graph snapshot, published atomically at step=epoch."""
        leaves, extra = self._leaves_manifest(
            epoch=epoch, state=state, ring=ring, linearization=linearization,
            epoch_log=epoch_log, next_batch_id=next_batch_id,
            index_stamp=index_stamp)
        with _trace.span("ckpt.save", epoch=int(epoch), leaves=len(leaves)):
            t0 = time.perf_counter()
            self.inner.save(int(epoch), leaves, extra=extra,
                            blocking=blocking)
            if blocking and _trace.enabled():
                _obs_registry().observe("ckpt.save_s",
                                        time.perf_counter() - t0)

    def save_torn(self, *, epoch, state, ring, linearization, epoch_log,
                  next_batch_id, index_stamp=None) -> None:
        """The ``ckpt-mid-write`` crash: the tmp dir is fully written but
        the rename never happens, so ``restore`` loads the PREVIOUS step."""
        self.inner.wait()
        leaves, extra = self._leaves_manifest(
            epoch=epoch, state=state, ring=ring, linearization=linearization,
            epoch_log=epoch_log, next_batch_id=next_batch_id,
            index_stamp=index_stamp)
        manifest = {
            "step": int(epoch),
            "treedef": "torn",
            "n_leaves": len(leaves),
            "shapes": [list(x.shape) for x in leaves],
            "dtypes": [str(x.dtype) for x in leaves],
            "shard_hint": "torn write (crash simulation)",
            "extra": extra,
            "time": time.time(),
        }
        self.inner._write(int(epoch), leaves, manifest, publish=False)

    def latest_step(self) -> int | None:
        return self.inner.latest_step()

    def _load(self, step, dev, parts: dict):
        t0 = time.perf_counter()
        leaves, manifest = self.inner.restore_raw(step=step)
        extra = manifest["extra"]
        if extra.get("kind") != "graph":
            raise RecoveryError(f"checkpoint step {manifest['step']} is not "
                                f"a graph snapshot")
        n = int(extra["n_state_leaves"])
        t1 = time.perf_counter()
        state = _state_from_leaves(leaves[:n], dev)
        _sync(dev)
        t2 = time.perf_counter()
        ring = EpochRing.load(leaves[n:], extra["ring_meta"], device=dev)
        _sync(dev)
        parts.update(ckpt_load=t1 - t0, to_device=t2 - t1,
                     ring_load=time.perf_counter() - t2)
        return state, ring, extra

    def restore_graph(self, *, step=None, device=None):
        """(GraphState, EpochRing, extra dict) of a published step, on the
        card unless ``device`` names another."""
        return self._load(step, resolve_device(device), {})


def _replay_apply(base, batch, *, auto_grow):
    """The pool's fused-apply-with-grow discipline, replicated exactly so
    replayed epochs are bit-identical to the ones the dead pool published;
    returns (state, host results, grows)."""
    grows = 0
    state, res = apply_ops_fast(base, batch)
    res = res.cpu().numpy()
    while auto_grow and (res == R_TABLE_FULL).any():
        base = grow(base, 2 * base.capacity)
        state, res = apply_ops_fast(base, batch)
        res = res.cpu().numpy()
        grows += 1
    return state, res, grows


def recover(ckpt: GraphCheckpointer | str | None,
            wal: WriteAheadLog | str | None, *, capacity: int = 32,
            mesh=None, auto_grow: bool = True, retain_epochs: int = 64,
            verify_results: bool = True, device=None) -> Recovered:
    """Latest checkpoint + WAL replay -> the pre-crash published prefix, on
    the card unless ``device`` names another (it raises when CUDA is absent
    and no device is named: never a quiet CPU fallback).

    ``ckpt``/``wal`` accept live objects or paths (or None: recover from
    the other alone; both None yields a fresh empty graph). ``capacity``
    only seats the fresh-graph case: a checkpoint carries its own.
    """
    if mesh is not None:
        raise TypeError("recover works on a GraphState on one device: "
                        "sharded states wait for ROADMAP.md queue A10")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if isinstance(ckpt, str):
        ckpt = GraphCheckpointer(ckpt)
    if isinstance(wal, str):
        wal = WriteAheadLog(wal)

    with _trace.span("recovery.restore") as sp:
        out = Recovered(state=None, epoch=0, ring=EpochRing(retain_epochs))
        # 1) newest durable checkpoint (a torn tmp dir is invisible: only
        #    renamed step_* dirs are addressable)
        state = None
        if ckpt is not None and ckpt.latest_step() is not None:
            state, ring, extra = ckpt._load(None, dev, out.parts)
            out.epoch = int(extra["epoch"])
            out.linearization = list(extra["linearization"])
            out.epoch_log = {int(k): int(v)
                             for k, v in extra["epoch_log"].items()}
            out.next_batch_id = int(extra["next_batch_id"])
            out.index_stamp = extra.get("index_stamp")
            out.ring = ring
            out.ckpt_step = int(extra["epoch"])
        if state is None:
            state = make_graph(capacity, device=dev)
            out.epoch_log = {0: 0}
            out.ring = EpochRing(retain_epochs)
            out.ring.reset(0, state)

        # 2) idempotent WAL replay of every epoch past the checkpoint
        t_replay = time.perf_counter()
        if wal is not None:
            for rec in wal.records():
                if rec.epoch <= out.epoch:
                    out.skipped_records += 1     # ckpt already covers it
                    continue
                if rec.epoch != out.epoch + 1:
                    raise RecoveryError(
                        f"WAL gap: have epoch {out.epoch}, next record is "
                        f"epoch {rec.epoch}")
                batch = make_op_batch(rec.ops, lanes=rec.pad, device=dev)
                state, res, _ = _replay_apply(state, batch,
                                              auto_grow=auto_grow)
                if verify_results and rec.results:
                    got = [int(x) for x in res[:rec.lanes]]
                    if got != [int(x) for x in rec.results]:
                        raise RecoveryError(
                            f"replay divergence at epoch {rec.epoch}: "
                            f"logged {rec.results} got {got}")
                out.linearization.extend(int(b) for b in rec.batch_ids)
                out.epoch = rec.epoch
                out.epoch_log[rec.epoch] = len(out.linearization)
                out.ring.push(rec.epoch, state)
                if rec.batch_ids:
                    out.next_batch_id = max(out.next_batch_id,
                                            max(rec.batch_ids) + 1)
                out.replayed_rounds += 1
        _sync(dev)
        out.parts["replay"] = time.perf_counter() - t_replay

        out.state = state
        out.restore_s = time.perf_counter() - t0
        sp.set(epoch=out.epoch, replayed=out.replayed_rounds,
               skipped=out.skipped_records)
        if _trace.enabled():
            _obs_registry().observe("recovery.restore_s", out.restore_s)
    return out


def resume_pool(recovered: Recovered, **pool_kwargs):
    """An IngestPool that continues from a ``Recovered`` point: same
    published epoch, linearization log, epoch ring and ticket-id counter
    as the dead process."""
    pool = IngestPool(recovered.state, **pool_kwargs)
    pool._slots = [(recovered.epoch, recovered.state),
                   (recovered.epoch, recovered.state)]
    pool._cur = 0
    pool._head = recovered.state
    pool.ring = recovered.ring
    pool.linearization = list(recovered.linearization)
    pool.epoch_log = dict(recovered.epoch_log)
    pool._next_id = int(recovered.next_batch_id)
    pool.stats.epochs = recovered.epoch
    pool.stats.epochs_retained = len(pool.ring) + 1
    pool.stats.epochs_evicted = pool.ring.evicted
    return pool
