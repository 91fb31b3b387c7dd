"""Device time from ``torch.profiler``: what ran on the card, and when.

The profiler records the device's activity only (kernels, copies, fills)
and the CUDA runtime calls of the host. Its clock is matched to the
host's ``perf_counter_ns`` (the profiler stamps events with the wall
clock), checked against ``torch.cuda.synchronize`` calls made at known
host times, so that the harness's own spans (a ``submit``, a
``get_paths``) can be laid over the device's intervals. The busy-interval
arithmetic (the union of a trace's kernel, copy and fill intervals) is a
copy of ``chip_smoke.py::_busy_ms``'s.
"""
from __future__ import annotations

import bisect
import re
import time

from graphbench.harness.stats import merged, union_length

CALIBRATIONS = 8


def kernel_name(name: str) -> str:
    """A device event's name without return type, namespaces' anonymous
    parts, template arguments and parameters, at most 60 characters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    return re.split(r"[(<]", name)[0][:60].strip()


def host_epoch_offset() -> int:
    """Nanoseconds of the wall clock (``time.time_ns``, the profiler's
    clock) less ``perf_counter_ns``, read between two readings of the
    latter."""
    best = None
    for _ in range(16):
        p0 = time.perf_counter_ns()
        r = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, r - (p0 + p1) // 2)
    return best[1]


def matched_marks(syncs: list, marks: list, offset: int,
                  slack_ns: int = 20_000):
    """(marks whose host interval, on the profiler's clock, holds the
    start of a recorded ``cudaDeviceSynchronize``; the median lag of
    those starts behind their intervals' starts): how well ``offset``
    fits."""
    lags = []
    for t0, t1 in marks:
        i = bisect.bisect_left(syncs, t0 + offset - slack_ns)
        if i < len(syncs) and syncs[i] <= t1 + offset + slack_ns:
            lags.append(syncs[i] - (t0 + offset))
    lags.sort()
    return len(lags), (lags[len(lags) // 2] if lags else 0)


class DeviceTrace:
    """One traced interval: ``start()``, the work, ``stop()``; then
    ``device`` holds (start ns, end ns, name) of every device event on the
    host's clock."""

    def __init__(self):
        self.device: list = []
        self.runtime: list = []
        self.offset_ns = None     # profiler clock minus host clock
        self.matched = 0
        self.residual_ns = 0
        self.read_s = 0.0
        self._by_corr = None
        self._starts = None
        self._prof = None
        self._marks: list = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._offset = host_epoch_offset()
        for _ in range(CALIBRATIONS):
            torch.cuda.synchronize()
            t = time.perf_counter_ns()
            torch.cuda.synchronize()
            self._marks.append((t, time.perf_counter_ns()))

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        device, runtime = [], []
        for e in events:
            name = e.name()
            if "CUDA" in str(e.device_type()):
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               name, e.correlation_id()))
            elif name.startswith("cuda"):
                runtime.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                name, e.correlation_id()))
        self._prof = None
        syncs = sorted(r[0] for r in runtime
                       if r[2] == "cudaDeviceSynchronize")
        self.matched, self.residual_ns = matched_marks(syncs, self._marks,
                                                       self._offset)
        # the profiler stamps events with the wall clock; kept only where
        # the calibration syncs show it
        self.offset_ns = (self._offset if 2 * self.matched > len(self._marks)
                          else None)
        shift = self.offset_ns or 0
        self.device = sorted((a - shift, b - shift, n, c)
                             for a, b, n, c in device)
        self.runtime = sorted((a - shift, b - shift, n, c)
                              for a, b, n, c in runtime)
        self.read_s = time.perf_counter() - t0

    def summary(self, what: str) -> str:
        return (f"{what}: {len(self.device)} device events, "
                f"{len(self.runtime)} runtime calls, clock offset "
                f"{self._offset} ns matched by {self.matched} of "
                f"{len(self._marks)} calibration syncs (median lag "
                f"{self.residual_ns / 1e3:.1f} us), read in "
                f"{self.read_s:.1f} s")

    def busy_ns(self, lo: int, hi: int) -> float:
        """Nanoseconds of [lo, hi) in which the device ran something."""
        return union_length([(max(a, lo), min(b, hi)) for a, b, _, _ in
                             self.device if b > lo and a < hi])

    def launched_ns(self, lo: int, hi: int) -> float:
        """Device nanoseconds of the work that the runtime calls made in
        [lo, hi) of the host's clock enqueued (joined by the profiler's
        correlation ids, so the device's own clock does not matter)."""
        if self._by_corr is None:
            self._starts = [r[0] for r in self.runtime]
            self._by_corr = {}
            for a, b, _, c in self.device:
                self._by_corr.setdefault(c, []).append((a, b))
        i = bisect.bisect_left(self._starts, lo)
        j = bisect.bisect_left(self._starts, hi)
        return union_length([iv for r in self.runtime[i:j]
                             for iv in self._by_corr.get(r[3], ())])

    def idle_gaps(self, lo: int, hi: int) -> list:
        """(start, end) of every stretch of [lo, hi) with nothing on the
        device."""
        busy = merged([(max(a, lo), min(b, hi)) for a, b, _, _ in
                       self.device if b > lo and a < hi])
        gaps, at = [], lo
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < hi:
            gaps.append((at, hi))
        return gaps

    def by_name(self, lo: int, hi: int) -> dict:
        """{kernel name: seconds} of the device events inside [lo, hi)."""
        out: dict = {}
        for a, b, n, _ in self.device:
            if b > lo and a < hi:
                k = kernel_name(n)
                out[k] = out.get(k, 0.0) + (min(b, hi) - max(a, lo)) / 1e9
        return out
