"""The program's own spans on the host clock that the device trace uses.

``ctx.program_spans`` holds the events ``repro_torch.obs.trace`` recorded
in the second part of a traced window. Each event's ``ts`` counts
microseconds from the recorder's ``epoch_ns``, a ``perf_counter_ns``
reading, and ``DeviceTrace`` maps the device onto ``perf_counter_ns``:
so a span can be laid over the device's idle stretches. A program whose
recorder does not publish ``epoch_ns`` gives no clock; the readers that
need one return None there.

A thread's spans nest by containment (the benchmark's caller is one
thread), so at any instant one span is the innermost open one. Idle
while that is a request's root (``ROOTS``: a batch's ``serve.submit``, a
session's ``session.get_paths``, an ingest pool's admission round
``ingest.round``) or no span at all is idle that no layer names.
"""
from __future__ import annotations

# the outermost span of a request (a batch, a session, an ingest pool's
# admission round): idle under one of them, and under no span at all, is
# idle that no layer of the program names
ROOTS = frozenset({"serve.submit", "session.get_paths", "ingest.round"})


def epoch_ns():
    """The program recorder's clock origin, or None where it has none."""
    from repro_torch.obs import trace

    return getattr(trace.recorder(), "epoch_ns", None)


def host_spans(events: list, epoch: int, name: str | None = None) -> list:
    """(start ns, end ns, name, args) of the complete events (only those
    called ``name``, where given) on ``perf_counter_ns``, in start order,
    an enclosing span before the spans it holds."""
    out = []
    for e in events:
        if e.get("ph") != "X" or (name is not None and e["name"] != name):
            continue
        a = epoch + round(e["ts"] * 1e3)
        out.append((a, a + round(e["dur"] * 1e3), e["name"],
                    e.get("args", {})))
    out.sort(key=lambda s: (s[0], -s[1]))
    return out


def innermost(spans: list) -> list:
    """(start, end, span) stretches in which ``span`` is the innermost open
    one, in order, over ``host_spans`` of one thread; time under no span
    is in none of them."""
    out, stack, at = [], [], None

    def close(until):
        nonlocal at
        while stack and stack[-1][1] <= until:
            top = stack.pop()
            if top[1] > at:
                out.append((at, top[1], top))
            at = max(at, top[1])

    for s in spans:
        at = s[0] if at is None else at
        close(s[0])
        if stack and s[0] > at:
            out.append((at, s[0], stack[-1]))
        at = max(at, s[0])
        stack.append(s)
    if stack:
        close(stack[0][1])
    return out


def overlap_ns(xs: list, ys: list) -> int:
    """Length of the intersection of two ordered lists of disjoint
    (start, end, ...) intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def clock(ctx):
    """(epoch, idle gaps of part B's rounds) where the program publishes
    its clock origin and the device trace's clock was matched to the
    host's; None otherwise."""
    tr, epoch = ctx.trace_b, epoch_ns()
    if (tr is None or tr.offset_ns is None or not tr.device
            or epoch is None or not ctx.logs_b):
        return None
    return epoch, tr.idle_gaps(ctx.logs_b[0].t0, ctx.logs_b[-1].t1)

