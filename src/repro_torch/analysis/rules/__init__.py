"""Rule registry population: importing this package registers every rule
of the port's linter (DESIGN.md §15). Add new rules by creating a module
here that calls ``framework.register`` at import time and listing it
below."""
from repro_torch.analysis.rules import (  # noqa: F401  (registration side effects)
    design_refs,
    durable_ack,
    epoch_freshness,
    kernel_shapes,
    lock_order,
    metrics_doc,
    mirror_write,
    trace_purity,
    traversable,
)

__all__ = [
    "design_refs",
    "durable_ack",
    "epoch_freshness",
    "kernel_shapes",
    "lock_order",
    "metrics_doc",
    "mirror_write",
    "trace_purity",
    "traversable",
]
