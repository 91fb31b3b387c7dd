"""batch_p95_ms: the 95th percentile over every batch of the window of
its latency, from the start of its round to the return of its ``submit``
(a compaction of the store before it counts)."""
from graphbench.harness.stats import percentile


def read(ctx):
    return percentile([(lg.submit[1] - lg.t0) / 1e6 for lg in ctx.logs
                       if lg.submit is not None], 95)
