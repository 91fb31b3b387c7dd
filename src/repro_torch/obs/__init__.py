"""Observability for the port (DESIGN.md §14): spans and Perfetto export
(``trace``), the typed ``MetricsRegistry`` and the ``StatsView`` base the
stat blocks ride on (``metrics``). The same public names as ``repro.obs``.
"""
from repro_torch.obs.metrics import (
    GLOBAL,
    MetricsRegistry,
    OBS_METRICS,
    StatsView,
    global_registry,
)
from repro_torch.obs.trace import (
    capture,
    counter,
    disable,
    enable,
    enabled,
    fence,
    recorder,
    save,
    span,
)

__all__ = [
    "GLOBAL",
    "MetricsRegistry",
    "OBS_METRICS",
    "StatsView",
    "capture",
    "counter",
    "disable",
    "enable",
    "enabled",
    "fence",
    "global_registry",
    "recorder",
    "save",
    "span",
]
