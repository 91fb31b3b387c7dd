"""submit_ms.p50 (endpoints): the median wall of a ``GraphCoServer.submit``
call, the benchmark's own span around it, in the untraced last part of a
traced window (the profiler's overhead on every launch would inflate it
in the profiled part)."""
from graphbench.harness.stats import percentile


def read(ctx):
    return percentile([(lg.submit[1] - lg.submit[0]) / 1e6
                       for lg in ctx.logs_c if lg.submit is not None], 50)
