"""ops_per_s: every lane and every GetPath query completed in the window,
over the window's seconds (from its first round's start to its last
round's return), on the host's clock."""


def read(ctx):
    ops = sum(lg.ops for lg in ctx.logs)
    return ops / ((ctx.t1 - ctx.t0) / 1e9)
