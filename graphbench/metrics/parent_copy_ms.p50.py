"""parent_copy_ms.p50 (session): the median wall of the program's
``session.to_host`` span, in the second part of a traced window: a
GetPath session's one copy of ``parent`` ([Q, V] int32), ``found``, the
endpoint slots and the slot keys from the device to the host. Nothing
where the program records no such span."""
from graphbench.harness.stats import percentile


def read(ctx):
    return percentile([e["dur"] / 1e3 for e in ctx.program_spans
                       if e.get("ph") == "X"
                       and e["name"] == "session.to_host"], 50)
