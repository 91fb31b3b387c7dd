"""Write-ahead log for the port's multi-tenant ingest pool (DESIGN.md §16):
the port's own copy of ``repro.runtime.wal`` (which imports no JAX), kept
byte for byte in its framing so that either package reads the other's log.

Durability contract: every admitted fused round appends exactly ONE
record (the linearized op list plus the admission outcome: client ids,
lanes, epoch, per-ticket result codes), and the pool may acknowledge the
round to clients only after that record is fsync-durable. The ordering is

    append -> flush -> fsync -> publish epoch -> ack clients

so a kill -9 at any point loses only *unacknowledged* work. Recovery
(``runtime/recovery.py``) replays the tail of this log on top of the
latest graph checkpoint through the same ``apply_ops_fast`` engine the
live pool uses, which makes the recovered state bit-identical to the
pre-crash published prefix.

Record framing (all little-endian):

    MAGIC (4 bytes, b"RWAL") | length u32 | crc32 u32 | payload JSON

The CRC covers the payload bytes only. The payload is JSON with
``separators=(",", ":")`` in the key order of ``WalRecord.to_payload``.
Every number in a record is a Python ``int`` (``json.dumps`` raises on
numpy and torch scalars), and each op keeps the length its client gave
it: ``[op, k1]``, ``[op, k1, k2]`` or ``[op, k1, k2, expect]``.

A torn tail (short frame, magic mismatch, or checksum mismatch) marks
the end of the valid prefix: ``open`` truncates the file back to the last
whole record, so a crash mid-append (``wal-append`` stage) can never
resurrect a half-written round. ``truncate_through(epoch)`` keeps the log
bounded behind a checkpoint: it atomically rewrites the log with only the
records strictly newer than the checkpointed epoch.
"""
from __future__ import annotations

import json
import os
import pathlib
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Iterator, Optional

MAGIC = b"RWAL"
_HEADER = struct.Struct("<4sII")  # magic, payload length, crc32


@dataclass
class WalStats:
    """Counters the ingest pool folds into ``IngestStats``."""

    records: int = 0          # records appended this process lifetime
    bytes: int = 0            # bytes appended (headers included)
    truncations: int = 0      # truncate_through calls
    torn_drops: int = 0       # torn-tail bytes discarded on open
    append_s: float = 0.0     # cumulative wall time inside append()


@dataclass
class WalRecord:
    """One durable fused round, exactly as replay needs it."""

    epoch: int                      # epoch published for this round
    ops: list                       # [[opcode, k1, k2], ...] linearized order
    pad: int                        # lane count the fused batch was padded to
    clients: list = field(default_factory=list)   # client id per admitted batch
    batch_ids: list = field(default_factory=list)  # pool ticket ids, ack order
    results: list = field(default_factory=list)   # per-op result codes
    lanes: int = 0                  # real (unpadded) op count

    def to_payload(self) -> bytes:
        return json.dumps({
            "epoch": self.epoch, "ops": self.ops, "pad": self.pad,
            "clients": self.clients, "batch_ids": self.batch_ids,
            "results": self.results, "lanes": self.lanes,
        }, separators=(",", ":")).encode("utf-8")

    @classmethod
    def from_payload(cls, payload: bytes) -> "WalRecord":
        d = json.loads(payload.decode("utf-8"))
        return cls(epoch=int(d["epoch"]), ops=[list(o) for o in d["ops"]],
                   pad=int(d["pad"]), clients=list(d.get("clients", [])),
                   batch_ids=list(d.get("batch_ids", [])),
                   results=list(d.get("results", [])),
                   lanes=int(d.get("lanes", len(d["ops"]))))


class WriteAheadLog:
    """Append-only checksummed log with torn-tail recovery.

    Opening an existing log scans it front to back; the first frame that
    fails magic/length/CRC validation ends the valid prefix and the file
    is truncated there (the ``wal-append`` crash leaves exactly such a
    tail).  Appends are ``write + flush + fsync`` before returning — the
    caller's ack must happen after ``append`` returns, never before.
    """

    def __init__(self, path, *, clock=None):
        self.path = pathlib.Path(path)
        self.stats = WalStats()
        self._clock = clock  # perf counter for append_s; None = time.perf_counter
        self.path.parent.mkdir(parents=True, exist_ok=True)
        valid_end, n = self._scan()
        size = self.path.stat().st_size if self.path.exists() else 0
        if size > valid_end:
            # torn tail: drop everything past the last whole record
            self.stats.torn_drops += size - valid_end
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())
        self._n_records = n
        self._f = open(self.path, "ab")

    # -- internal ---------------------------------------------------------
    def _scan(self) -> tuple[int, int]:
        """Return (byte offset of valid prefix end, record count)."""
        if not self.path.exists():
            return 0, 0
        end = 0
        n = 0
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                magic, length, crc = _HEADER.unpack(header)
                if magic != MAGIC:
                    break
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break
                try:
                    WalRecord.from_payload(payload)
                except (ValueError, KeyError):
                    break
                end = f.tell()
                n += 1
        return end, n

    def _frame(self, payload: bytes) -> bytes:
        return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload

    # -- public API -------------------------------------------------------
    def __len__(self) -> int:
        return self._n_records

    def append(self, record: WalRecord) -> None:
        """Durably append one record: write, flush, fsync. Only after
        this returns may the caller publish the epoch and ack clients
        (``test_round_order_is_append_publish_ack_checkpoint`` pins the
        pool's call-site order)."""
        clock = self._clock or time.perf_counter
        t0 = clock()
        frame = self._frame(record.to_payload())
        self._f.write(frame)
        self._f.flush()
        os.fsync(self._f.fileno())
        self._n_records += 1
        self.stats.records += 1
        self.stats.bytes += len(frame)
        self.stats.append_s += clock() - t0

    def append_torn(self, record: WalRecord, keep_bytes: Optional[int] = None
                    ) -> None:
        """Simulate the ``wal-append`` crash: write a PARTIAL frame (no
        fsync of a whole record) so the next open sees a torn tail and
        truncates it.  ``keep_bytes`` defaults to header + half the
        payload."""
        frame = self._frame(record.to_payload())
        if keep_bytes is None:
            keep_bytes = _HEADER.size + max(1, (len(frame) - _HEADER.size) // 2)
        keep_bytes = max(1, min(keep_bytes, len(frame) - 1))
        self._f.write(frame[:keep_bytes])
        self._f.flush()
        os.fsync(self._f.fileno())

    def records(self) -> Iterator[WalRecord]:
        """Iterate the valid records currently on disk (front to back)."""
        self._f.flush()
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    return
                magic, length, crc = _HEADER.unpack(header)
                if magic != MAGIC:
                    return
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return
                yield WalRecord.from_payload(payload)

    def truncate_through(self, epoch: int) -> int:
        """Drop every record with ``record.epoch <= epoch`` (they are
        covered by a durable checkpoint).  Atomic: rewrites to a temp
        file and renames over the log.  Returns records kept."""
        kept = [r for r in self.records() if r.epoch > epoch]
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "wb") as f:
            for r in kept:
                f.write(self._frame(r.to_payload()))
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.rename(tmp, self.path)
        dirfd = os.open(str(self.path.parent), os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._f = open(self.path, "ab")
        self._n_records = len(kept)
        self.stats.truncations += 1
        return len(kept)

    def size_bytes(self) -> int:
        self._f.flush()
        return self.path.stat().st_size if self.path.exists() else 0

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:  # pragma: no cover - best effort on shutdown
            pass
