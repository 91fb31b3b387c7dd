"""launch_enqueue_us.p50 (kernels): the median wall of the program's
``kernel.launch`` span, in microseconds, in the second part of a traced
window: the host's call into a kernel library's C launcher, which only
enqueues the kernel. Nothing where the program launched no kernel or
records no such span."""
from graphbench.harness.stats import percentile


def read(ctx):
    return percentile([e["dur"] for e in ctx.program_spans
                       if e.get("ph") == "X"
                       and e["name"] == "kernel.launch"], 50)
