"""batches_per_apply (ingest): the client batches an ingest pool coalesces
into one fused apply, the mean ``batches`` of the program's
``ingest.fused_apply`` spans in the second part of a traced window.
Nothing where the program records no such span."""


def read(ctx):
    fused = [e["args"]["batches"] for e in ctx.program_spans
             if e.get("ph") == "X" and e["name"] == "ingest.fused_apply"
             and "batches" in e.get("args", {})]
    return sum(fused) / len(fused) if fused else None
