"""Named phase timers on the host clock, and a `torch.profiler` trace.

`PhaseTimers.phase(name)` adds the wall time of a block to that phase.
The clock is the host's and nothing here synchronizes the card: on CUDA
tensors a phase measures what the host spends in it (launching kernels,
and waiting where the block itself reads a result back, as `.item()`
or `torch.nonzero` do), not the device time of the work it queued.  A
phase that ends in such a read also absorbs the device work queued
before it.  `torch_trace` gives device time.
"""

import contextlib
import time
from collections import defaultdict


class PhaseTimers:
    """Wall time per phase, with the first sample and the maximum kept
    apart from the warm value.

    A phase's first sample carries one-time costs (a kernel build, the
    allocator's first growth, cuDNN's algorithm search), so `warm_ms` is
    the median of the last `RECENT` samples, and `first_ms` / `max_ms`
    show the outliers instead of smearing them into a mean.
    """

    RECENT = 20

    def __init__(self):
        self.reset()

    def reset(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.recent = defaultdict(list)
        self.first = {}
        self.maxes = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.first.setdefault(name, dt)
            self.maxes[name] = max(self.maxes[name], dt)
            r = self.recent[name]
            r.append(dt)
            if len(r) > self.RECENT:
                r.pop(0)

    @staticmethod
    def _median(xs):
        s = sorted(xs)
        n = len(s)
        if n == 0:
            return 0.0
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def summary(self):
        """{phase: total_s, count, mean_ms, warm_ms, first_ms, max_ms}."""
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name],
                                                         1),
                "warm_ms": 1e3 * self._median(self.recent[name]),
                "first_ms": 1e3 * self.first.get(name, 0.0),
                "max_ms": 1e3 * self.maxes[name],
            }
            for name in sorted(self.totals)
        }

    def report(self):
        lines = ["host-clock phase times (the card is not synchronized: "
                 "launch and host-read time, not device time)",
                 f"{'phase':24s} {'count':>6s} {'warm ms':>10s} "
                 f"{'mean ms':>10s} {'first ms':>10s} {'max ms':>10s} "
                 f"{'total s':>9s}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:24s} {s['count']:6d} {s['warm_ms']:10.2f} "
                f"{s['mean_ms']:10.2f} {s['first_ms']:10.2f} "
                f"{s['max_ms']:10.2f} {s['total_s']:9.2f}")
        return "\n".join(lines)


GLOBAL_TIMERS = PhaseTimers()


@contextlib.contextmanager
def torch_trace(logdir):
    """Profile a region with `torch.profiler` (CPU and, on a card, CUDA
    activity) and write a Chrome trace to `logdir/trace.json`; yields the
    profiler, whose `key_averages()` sums the time by kernel."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
