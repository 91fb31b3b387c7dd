"""peak_mem_gb (device): ``torch.cuda.max_memory_allocated()`` over the
profiled part of a traced window, after a reset at its start, in GB."""


def read(ctx):
    if not ctx.window_peak_bytes:
        return None
    return ctx.window_peak_bytes / 1e9
