"""mutation_device_ms (mutation): device busy milliseconds inside a
``submit`` span, per batch: the union of the device's kernel, copy and
fill intervals under ``torch.profiler`` that fall inside the span, the
mean over the profiled part's batches. Nothing where the profiler's clock
could not be matched to the host's."""


def read(ctx):
    tr = ctx.trace_a
    spans = [lg.submit for lg in ctx.logs if lg.submit is not None]
    if tr is None or tr.offset_ns is None or not spans or not tr.device:
        return None
    return sum(tr.busy_ns(a, b) for a, b in spans) / len(spans) / 1e6
