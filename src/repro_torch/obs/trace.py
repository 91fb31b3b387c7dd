"""Hierarchical spans + Perfetto export for the port: the port of
``repro.obs.trace`` (DESIGN.md §14).

One process-global recorder collects spans: named, timed, attributed
intervals. It is off by default; disabled, ``span()`` returns a shared
no-op object, so the instrumented hot path costs one attribute check.
Enable with ``REPRO_TRACE=1`` (read at import), ``enable()`` or
``capture()``; ``save(path)`` writes Chrome trace-event JSON that Perfetto
and ``chrome://tracing`` load (``None`` uses ``REPRO_TRACE_PATH``). Span
and counter names match the JAX package's (``bfs.session``,
``bfs.superstep``, ``session.get_paths``, ``collect.round``,
``ingest.round``, ``ingest.admit``, ``ingest.fused_apply``,
``ring.state_at``, ``index.ring_validate``, ...), so the same trace tools
read both.

``fence(x)`` makes a span measure device work: while tracing it calls
``torch.cuda.synchronize()`` when ``x`` holds CUDA tensors.

The port also emits spans the JAX package has no twin for (``PORT_SPANS``,
DESIGN.md §14 "Port-only spans"): the write path from
``GraphCoServer.submit`` down to the serial pass, the host side of a
GetPath session, the enqueue of each CUDA kernel, and the ingest pool's
seat and publish with the epoch ring's push. None of them fences. Every
event's ``ts`` counts microseconds from ``TraceRecorder.epoch_ns``, a
``time.perf_counter_ns()`` reading that ``export()`` also writes as
``otherData.perf_counter_epoch_ns``, so a span can be laid over a device
trace kept on that clock.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

_TRUTHY = {"1", "true", "yes", "on"}

# spans of the port that the JAX package does not emit; tests that compare
# the two packages' events drop exactly these names
PORT_SPANS = frozenset({
    "serve.submit", "serve.make_batch", "serve.codes_to_host", "serve.grow",
    "ops.apply", "ops.schedule", "ops.copy", "ops.clean_pass",
    "ops.serial_pass", "session.materialize", "session.to_host",
    "session.path_walk", "session.compare", "kernel.launch",
    "ingest.seat", "ingest.publish", "ring.push"})


class _NullSpan:
    """Shared do-nothing span: the entire disabled-tracer hot path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL = _NullSpan()


class _LiveSpan:
    """One open interval; appends a complete ("X") event on exit."""

    __slots__ = ("_rec", "name", "attrs", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, attrs: dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs
        self._t0 = 0

    def set(self, **attrs):
        """Attach or overwrite attributes mid-flight (e.g. a direction tag
        known only after the superstep ran)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        self._rec._emit(self.name, self._t0, dur, self.attrs)
        return False


class TraceRecorder:
    """Process-global span/counter sink; thread-safe appends."""

    def __init__(self):
        self.enabled = False
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self.epoch_ns = time.perf_counter_ns()   # the origin of every ts

    def _event(self, name: str, ph: str, t0_ns: int) -> dict:
        return {"name": name, "ph": ph,
                "ts": (t0_ns - self.epoch_ns) / 1e3,   # microseconds
                "pid": os.getpid(), "tid": threading.get_ident() & 0xFFFF}

    def _emit(self, name: str, t0_ns: int, dur_ns: int, attrs: dict) -> None:
        ev = self._event(name, "X", t0_ns)
        ev["dur"] = dur_ns / 1e3
        if attrs:
            ev["args"] = attrs
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, value) -> None:
        """One counter ("C") sample: a stepped time series in Perfetto."""
        if not self.enabled:
            return
        ev = self._event(name, "C", time.perf_counter_ns())
        ev["args"] = {"value": value}
        with self._lock:
            self._events.append(ev)

    def start(self, fresh: bool = False) -> None:
        with self._lock:
            if fresh:
                self._events = []
            self.enabled = True

    def stop(self) -> None:
        with self._lock:
            self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def export(self) -> dict:
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"perf_counter_epoch_ns": self.epoch_ns}}

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.export(), f)
        return path


_RECORDER = TraceRecorder()


def recorder() -> TraceRecorder:
    """The process-global recorder."""
    return _RECORDER


def enabled() -> bool:
    """The host-side tracing switch every instrumented layer checks."""
    return _RECORDER.enabled


def span(name: str, **attrs):
    """Open a span; disabled, the shared no-op singleton."""
    if not _RECORDER.enabled:
        return _NULL
    return _LiveSpan(_RECORDER, name, attrs)


def null_span(name: str = "", **attrs):
    """``span``'s disabled form, whatever the recorder's state: for a layer
    that records no span of its own even while tracing is on."""
    return _NULL


def counter(name: str, value) -> None:
    """Record a counter sample (no-op when disabled)."""
    _RECORDER.counter(name, value)


def enable(fresh: bool = False) -> None:
    _RECORDER.start(fresh=fresh)


def disable() -> None:
    _RECORDER.stop()


def save(path: str | None = None) -> str:
    """Write the trace JSON; ``None`` uses ``REPRO_TRACE_PATH`` (default
    ``repro_trace.json``)."""
    return _RECORDER.save(path if path is not None else os.environ.get(
        "REPRO_TRACE_PATH", "repro_trace.json"))


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, (tuple, list)):
        return any(_on_cuda(y) for y in x)
    if callable(getattr(x, "tensors", None)):   # a sharded graph state
        return _on_cuda(x.tensors())
    return False


def fence(x):
    """Device-timing fence: while tracing, wait for the card when ``x``
    holds CUDA tensors, so the enclosing span measures device work; a pass
    through otherwise."""
    if _RECORDER.enabled and _on_cuda(x):
        torch.cuda.synchronize()
    return x


@contextlib.contextmanager
def capture():
    """Enable a fresh trace for the block and yield the recorder; restores
    the previous enabled state on exit."""
    was = _RECORDER.enabled
    _RECORDER.start(fresh=True)
    try:
        yield _RECORDER
    finally:
        if not was:
            _RECORDER.stop()


if os.environ.get("REPRO_TRACE", "").strip().lower() in _TRUTHY:
    _RECORDER.start()
