"""getpath_p95_ms: the 95th percentile over every GetPath query of the
window of its latency, from the start of its round to the return of the
``get_paths`` call that answered it (a query of a round with a batch
waits for the batch too)."""
from graphbench.harness.stats import percentile


def read(ctx):
    lat = []
    for lg in ctx.logs:
        if lg.session is not None:
            lat += [(lg.session[1] - lg.t0) / 1e6] * lg.queries
    return percentile(lat, 95)
