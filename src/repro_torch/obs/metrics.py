"""Typed metrics registry and registry-backed stat views for the port: the
port of ``repro.obs.metrics`` (DESIGN.md §14).

  * ``MetricsRegistry``: a typed (counter | gauge | histogram) name ->
    value store. Counters and gauges are plain numbers; histograms keep
    (count, sum, min, max).
  * ``StatsView``: a dataclass-shaped view over a registry. Subclasses
    declare ``_PREFIX`` and ``_SPEC`` (field -> (kind, default)); attribute
    reads and writes go to the registry entry ``"<prefix>.<field>"``, so
    ``stats.field += n`` works as on a dataclass while one registry
    snapshot serves every view on it (``IngestStats``, ``ServeStats``).
  * ``GLOBAL``: the process-global registry of the tracing-only metrics
    (``OBS_METRICS``), updated only while ``trace.enabled()``.

The names and kinds are the JAX package's, so one DESIGN.md §14 table
covers both packages.
"""
from __future__ import annotations

import threading

_KINDS = ("counter", "gauge", "histogram")


class MetricsRegistry:
    """Typed name -> metric store. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kinds: dict[str, str] = {}
        self._values: dict[str, object] = {}

    def declare(self, name: str, kind: str, default=0) -> None:
        """Declare ``name`` once; a second declaration of the same kind is
        a no-op, of another kind a ``ValueError``."""
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r} for {name!r}")
        with self._lock:
            prev = self._kinds.get(name)
            if prev is not None and prev != kind:
                raise ValueError(
                    f"metric {name!r} re-declared as {kind} (was {prev})")
            if name not in self._values:
                self._kinds[name] = kind
                self._values[name] = (
                    {"count": 0, "sum": 0.0, "min": None, "max": None}
                    if kind == "histogram" else default)

    def kind(self, name: str) -> str:
        return self._kinds[name]

    def get(self, name: str):
        with self._lock:
            return self._values[name]

    def set(self, name: str, value) -> None:
        with self._lock:
            if self._kinds.get(name) == "histogram":
                raise TypeError(f"histogram {name!r} takes observe(), not set()")
            self._values[name] = value

    def inc(self, name: str, delta=1) -> None:
        with self._lock:
            self._values[name] = self._values[name] + delta

    def observe(self, name: str, value) -> None:
        """Add one sample to histogram ``name``."""
        with self._lock:
            h = self._values[name]
            h["count"] += 1
            h["sum"] += value
            h["min"] = value if h["min"] is None else min(h["min"], value)
            h["max"] = value if h["max"] is None else max(h["max"], value)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._kinds)

    def snapshot(self) -> dict:
        """One flat dict of current values (histograms as copied dicts): the
        payload of the ``get_metrics`` serving endpoint."""
        with self._lock:
            return {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in sorted(self._values.items())}


class StatsView:
    """Dataclass-shaped view over a ``MetricsRegistry``.

    Each ``_SPEC`` field is a plain attribute whose storage is the registry
    entry ``"<prefix>.<field>"``."""

    _PREFIX = ""
    _SPEC: dict[str, tuple] = {}

    def __init__(self, registry: MetricsRegistry | None = None):
        object.__setattr__(self, "registry",
                           registry if registry is not None
                           else MetricsRegistry())
        for name, (kind, default) in self._SPEC.items():
            self.registry.declare(self._qual(name), kind, default)

    @classmethod
    def _qual(cls, name: str) -> str:
        return f"{cls._PREFIX}.{name}" if cls._PREFIX else name

    def __getattr__(self, name: str):
        if name in type(self)._SPEC:
            return self.registry.get(self._qual(name))
        raise AttributeError(
            f"{type(self).__name__} has no field {name!r}")

    def __setattr__(self, name: str, value) -> None:
        if name in type(self)._SPEC:
            self.registry.set(self._qual(name), value)
        else:
            object.__setattr__(self, name, value)

    def snapshot(self) -> dict:
        """field -> current value (unprefixed, view-local)."""
        return {name: getattr(self, name) for name in self._SPEC}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={getattr(self, k)!r}" for k in self._SPEC)
        return f"{type(self).__name__}({body})"


# Tracing-only global metrics, updated only under ``trace.enabled()``.
OBS_METRICS: dict[str, tuple[str, str]] = {
    "bfs.supersteps": ("counter", "traced fused supersteps executed"),
    "bfs.pull_supersteps": ("counter", "traced supersteps that chose pull"),
    "bfs.direction_flips": ("counter",
                            "push<->pull switches across traced supersteps"),
    "bfs.exchange_bytes": ("counter",
                           "sharded frontier-exchange bytes (packed words)"),
    "ingest.round_s": ("histogram", "wall seconds per admission round"),
    "ingest.fused_apply_s": ("histogram",
                             "device wall seconds per fused apply"),
    "index.query_s": ("histogram", "wall seconds per index query batch"),
    "index.ring_validate_s": ("histogram",
                              "wall seconds per ring-validated serve"),
    "index.fallback_s": ("histogram",
                         "wall seconds per BFS-fallback session"),
    "ring.occupancy": ("gauge", "delta records currently retained"),
    "ring.evictions": ("counter", "delta records dropped by retention"),
    "ring.resolve_depth": ("histogram",
                           "XOR records replayed per state_at()"),
    "wal.append_s": ("histogram",
                     "wall seconds per durable WAL append (incl. fsync)"),
    "ckpt.save_s": ("histogram",
                    "wall seconds per published graph checkpoint"),
    "recovery.restore_s": ("histogram",
                           "wall seconds per checkpoint+WAL recovery"),
    "serve.degraded": ("gauge",
                       "1 while the server recovers (pinned reads, "
                       "R_RECOVERING writes)"),
}

GLOBAL = MetricsRegistry()
for _name, (_kind, _doc) in OBS_METRICS.items():
    GLOBAL.declare(_name, _kind)


def global_registry() -> MetricsRegistry:
    """The process-global tracing-metrics registry."""
    return GLOBAL
