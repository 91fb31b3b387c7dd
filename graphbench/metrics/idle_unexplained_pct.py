"""idle_unexplained_pct (device): the share of the device's idle time in
the second part of a traced window, in percent, during which the
innermost open program span is a request's root (``serve.submit``,
``session.get_paths``, and a client round's ``ingest.round``, which holds
only ``ingest.admit`` and ``ingest.fused_apply``) or there is no span at
all: idle that no layer of the program names. The spans are laid over
the device trace of the same part on the host's clock
(``harness/spans.py``). Nothing where the clocks were not matched or the
device was never idle."""
from graphbench.harness import spans as sp


def read(ctx):
    at = sp.clock(ctx)
    if at is None:
        return None
    epoch, idle = at
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    named = [s for s in sp.innermost(sp.host_spans(ctx.program_spans, epoch))
             if s[2][2] not in sp.ROOTS]
    return 100.0 * (total - sp.overlap_ns(named, idle)) / total
