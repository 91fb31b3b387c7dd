"""publish_ms.p50 (ingest): the median wall of the program's
``ingest.publish`` span, in milliseconds, in the second part of a traced
window: an ingest pool's publish of a round's state as its next epoch,
the slot flip and the epoch ring's push (the diff against the last
published state, and the copy of its changed rows home). Nothing where
the program records no such span."""
from graphbench.harness.stats import percentile


def read(ctx):
    return percentile([e["dur"] / 1e3 for e in ctx.program_spans
                       if e.get("ph") == "X"
                       and e["name"] == "ingest.publish"], 50)
