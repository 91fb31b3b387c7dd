"""device_idle_pct (device): the share of the profiled part of a traced
window in which nothing ran on the device, in percent (100 less the union
of its kernel, copy and fill intervals over the part's wall)."""


def read(ctx):
    tr = ctx.trace_a
    if tr is None or tr.offset_ns is None or not tr.device:
        return None
    busy = tr.busy_ns(ctx.t0, ctx.t1)
    return 100.0 * (1.0 - busy / (ctx.t1 - ctx.t0))
