"""batch_p95_ms: the 95th percentile over every batch of the window of
its latency, from the start of its round to the return of its ``submit``
(a compaction of the store before it counts); of a ``clients`` round,
for each client batch the server applied, to the return of the ``pump``
it landed at."""
from graphbench.harness.stats import percentile


def read(ctx):
    lat = []
    for lg in ctx.logs:
        if lg.tickets is not None:
            lat += [(tk.done_ns - lg.t0) / 1e6 for tk in lg.tickets
                    if tk.status == "applied"]
        elif lg.submit is not None:
            lat.append((lg.submit[1] - lg.t0) / 1e6)
    return percentile(lat, 95)
