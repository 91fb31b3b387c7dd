"""ring_host_mb_per_publish (ingest): the megabytes (10^6 bytes) the epoch
ring copies from the device to the host in one push, the mean ``bytes``
of the program's ``ring.push`` spans in the second part of a traced
window: the published state's version vector and the XOR patches of the
rows that changed since the last publish. Nothing where the program
records no such span."""


def read(ctx):
    pushed = [e["args"]["bytes"] for e in ctx.program_spans
              if e.get("ph") == "X" and e["name"] == "ring.push"
              and "bytes" in e.get("args", {})]
    return sum(pushed) / len(pushed) / 1e6 if pushed else None
