"""session_ms.p50 (session): the median wall of a
``GraphCoServer.get_paths`` call, the benchmark's own span around it, in
the untraced last part of a traced window (the profiler's overhead on
every launch would inflate it in the profiled part)."""
from graphbench.harness.stats import percentile


def read(ctx):
    return percentile([(lg.session[1] - lg.session[0]) / 1e6
                       for lg in ctx.logs_c if lg.session is not None], 50)
