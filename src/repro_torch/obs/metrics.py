"""Typed metrics registry for the port (the slice of ``repro.obs.metrics``
that the main path and the index call).

``global_registry()`` holds the tracing-only metrics; they are updated only
while ``trace.enabled()``, so the disabled hot path never touches them.
Counters are plain numbers; histograms keep (count, sum, min, max). The
names and kinds match the JAX package's.
"""
from __future__ import annotations

import threading

OBS_METRICS: dict[str, tuple[str, str]] = {
    "bfs.supersteps": ("counter", "traced fused supersteps executed"),
    "bfs.pull_supersteps": ("counter", "traced supersteps that chose pull"),
    "bfs.direction_flips": ("counter",
                            "push<->pull switches across traced supersteps"),
    "index.query_s": ("histogram", "wall seconds per index query batch"),
    "index.ring_validate_s": ("histogram",
                              "wall seconds per ring-validated serve"),
    "index.fallback_s": ("histogram",
                         "wall seconds per BFS-fallback session"),
}


def _empty(kind: str):
    if kind == "histogram":
        return {"count": 0, "sum": 0.0, "min": None, "max": None}
    return 0


class MetricsRegistry:
    """Name -> counter or histogram store. Thread-safe."""

    def __init__(self, metrics: dict[str, tuple[str, str]] | None = None):
        self._lock = threading.Lock()
        self._values: dict[str, object] = {
            n: _empty(kind) for n, (kind, _doc) in (metrics or {}).items()}

    def inc(self, name: str, delta: int = 1) -> None:
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

    def snapshot(self) -> dict:
        """One flat dict of current values (histograms as copied dicts)."""
        with self._lock:
            return {k: (dict(v) if isinstance(v, dict) else v)
                    for k, v in sorted(self._values.items())}


_GLOBAL = MetricsRegistry(OBS_METRICS)


def global_registry() -> MetricsRegistry:
    """The process-global tracing-metrics registry."""
    return _GLOBAL
