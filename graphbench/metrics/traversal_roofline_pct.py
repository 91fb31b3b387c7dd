"""traversal_roofline_pct (kernels): the traversal kernels' least time
over their device time, in percent, over every B1, B2 and B3 launch of
the second part of a traced window: the sum of each launch's bound
(``harness/roofline.py``: the larger of its bytes over 3.35 TB/s and its
operations over 67 T/s) over the sum of the device time of the work each
launch enqueued, which the profiler joins to the launch's runtime calls.
Nothing without a launch, or where the profiler's clock could not be
matched to the host's."""
from graphbench.harness.roofline import bound_s


def read(ctx):
    tr = ctx.trace_b
    if tr is None or tr.offset_ns is None or not ctx.launches:
        return None
    bound = sum(bound_s(nb, ops) for _, _, _, nb, ops in ctx.launches)
    device = sum(tr.launched_ns(a, b) for _, a, b, _, _ in ctx.launches)
    if device <= 0:
        return None
    return 100.0 * bound / (device / 1e9)
