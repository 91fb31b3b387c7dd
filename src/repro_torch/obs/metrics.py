"""Typed metrics registry for the port (the slice of ``repro.obs.metrics``
that the main path calls).

``global_registry()`` holds the tracing-only counters; they are bumped only
while ``trace.enabled()``, so the disabled hot path never touches them.
The names match the JAX package's.
"""
from __future__ import annotations

import threading

OBS_METRICS: dict[str, str] = {
    "bfs.supersteps": "traced fused supersteps executed",
    "bfs.pull_supersteps": "traced supersteps that chose pull",
    "bfs.direction_flips": "push<->pull switches across traced supersteps",
}


class MetricsRegistry:
    """Name -> counter store. Thread-safe."""

    def __init__(self, names=()):
        self._lock = threading.Lock()
        self._values: dict[str, int] = {n: 0 for n in names}

    def inc(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._values[name] = self._values[name] + delta

    def snapshot(self) -> dict:
        with self._lock:
            return dict(sorted(self._values.items()))


_GLOBAL = MetricsRegistry(OBS_METRICS)


def global_registry() -> MetricsRegistry:
    """The process-global tracing-metrics registry."""
    return _GLOBAL
