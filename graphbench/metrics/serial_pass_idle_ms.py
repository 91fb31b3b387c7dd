"""serial_pass_idle_ms (mutation): milliseconds a batch in which the
device sits idle inside the program's ``ops.serial_pass`` span (the
conflicting lanes applied one by one on the host), summed over the
second part of a traced window and divided by its ``ops.apply`` spans.
The spans are laid over the device trace of the same part on the host's
clock (``harness/spans.py``). Nothing where the clocks were not matched
or the program records no such span."""
from graphbench.harness import spans as sp


def read(ctx):
    at = sp.clock(ctx)
    applies = [e for e in ctx.program_spans
               if e.get("ph") == "X" and e["name"] == "ops.apply"]
    if at is None or not applies:
        return None
    epoch, idle = at
    serial = sp.host_spans(ctx.program_spans, epoch, "ops.serial_pass")
    return sp.overlap_ns(serial, idle) / len(applies) / 1e6
