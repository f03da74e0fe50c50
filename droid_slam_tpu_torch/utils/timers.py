"""The port's tracer: named spans and host-sync counts on the host clock.

A span is `(name, t0_ns, t1_ns)` on `time.perf_counter_ns`, the clock
that the benchmark maps its device trace onto (benchmark/lib/trace.py),
so a span lines up with the kernels of that trace as it stands.  The
clock is the host's: a span measures what the host spends in it
(launching work, or waiting), not the device time of what it queued.

`sync_site(name)` wraps a call that makes the host wait for the CUDA
stream (`.item()`, `.cpu()`, `torch.nonzero`, a boolean index,
`torch.unique`, a blocking host-to-device copy): it counts the call's
host waits (`n`, one by default) and records the span `sync.<name>`.

The tracer records only while it is on: after `enable()`, or while a
`torch.profiler` session records; a span is kept when the tracer is on at
both its ends.  Off, a span site costs one flag test and returns a shared
null context.  It records no CUDA event, calls no synchronize and adds no
profiler annotation, so a device trace taken with it on holds the same
device work as one taken with it off.

Spans go into a ring of `CAPACITY` entries (the oldest overwritten);
the counts and total times per name stay exact when it wraps.

    from droid_slam_tpu_torch.utils import timers
    timers.enable()
    ...                                 # track frames, train steps
    print(timers.report())              # per name: count, warm/mean ms
    timers.spans(), timers.counts()     # the raw records
"""

import contextlib
import time

from torch.autograd import profiler as _profiler

CAPACITY = 1 << 20

# what a span site returns while the tracer is off
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "n", "t0")

    def __init__(self, tracer, name, n):
        self.tracer, self.name, self.n = tracer, name, n

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        # a span that outlives the recording (say, one around the call
        # that stops the profiler) is not the recording's: it is dropped
        if self.tracer.on or _profiler._is_profiler_enabled:
            self.tracer._close(self.name, self.t0, t1, self.n)
        return False


class Tracer:
    """Spans in a bounded ring, with exact counts and totals per name."""

    RECENT = 20          # spans of a name behind `warm_ms`

    def __init__(self, capacity=CAPACITY):
        self.capacity = capacity
        self.on = False
        self.reset()

    def reset(self):
        """Forget every record (the switch stays as it is)."""
        self._ring = []
        self._next = 0               # oldest slot, once the ring is full
        self._counts = {}
        self._ns = {}

    def enable(self, on=True):
        """Record from now on (`enable(False)`: only under the profiler)."""
        self.on = bool(on)

    def recording(self):
        return self.on or _profiler._is_profiler_enabled

    def span(self, name):
        """A context that records the span `name` while recording."""
        if not (self.on or _profiler._is_profiler_enabled):
            return _NULL
        return _Span(self, name, 1)

    def sync_site(self, name, n=1):
        """A context around a call that makes the host wait `n` times for
        the stream: counts the waits, records the span `sync.<name>`."""
        if not (self.on or _profiler._is_profiler_enabled):
            return _NULL
        return _Span(self, "sync." + name, n)

    def _close(self, name, t0, t1, n):
        if len(self._ring) < self.capacity:
            self._ring.append((name, t0, t1))
        else:
            self._ring[self._next] = (name, t0, t1)
            self._next = (self._next + 1) % self.capacity
        self._counts[name] = self._counts.get(name, 0) + n
        self._ns[name] = self._ns.get(name, 0) + (t1 - t0)

    def spans(self):
        """The ring's spans, oldest first, each (name, t0_ns, t1_ns)."""
        return self._ring[self._next:] + self._ring[:self._next]

    def counts(self):
        """{name: spans closed}; a `sync.` name counts its host waits."""
        return dict(self._counts)

    def totals_ns(self):
        """{name: summed span time in ns}."""
        return dict(self._ns)

    def innermost_at(self, t_ns):
        """Name of the shortest span in the ring that holds host time
        t_ns, or None (the first recorded wins a tie)."""
        best = None
        for name, a, b in self.spans():
            if a <= t_ns <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else None

    def summary(self):
        """{name: count, total_s, mean_ms, warm_ms, first_ms, max_ms}:
        count and total exact, the rest over the ring's spans (warm: the
        median of the last RECENT, as the first carries one-time costs)."""
        by_name = {}
        for name, a, b in self.spans():
            by_name.setdefault(name, []).append(b - a)
        out = {}
        for name in sorted(self._counts):
            d = by_name.get(name, [0])
            recent = sorted(d[-self.RECENT:])
            k = len(recent)
            warm = (recent[k // 2] if k % 2
                    else 0.5 * (recent[k // 2 - 1] + recent[k // 2]))
            out[name] = dict(
                count=self._counts[name], total_s=self._ns[name] / 1e9,
                mean_ms=self._ns[name] / 1e6 / max(self._counts[name], 1),
                warm_ms=warm / 1e6, first_ms=d[0] / 1e6,
                max_ms=max(d) / 1e6)
        return out

    def report(self):
        lines = ["host-clock span times (the card is not synchronized: "
                 "launch and host-wait time, not device time)",
                 f"{'span':28s} {'count':>7s} {'warm ms':>10s} "
                 f"{'mean ms':>10s} {'first ms':>10s} {'max ms':>10s} "
                 f"{'total s':>9s}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:28s} {s['count']:7d} {s['warm_ms']:10.3f} "
                f"{s['mean_ms']:10.3f} {s['first_ms']:10.3f} "
                f"{s['max_ms']:10.3f} {s['total_s']:9.3f}")
        return "\n".join(lines)


TRACER = Tracer()
enable = TRACER.enable
recording = TRACER.recording
span = TRACER.span
sync_site = TRACER.sync_site
spans = TRACER.spans
counts = TRACER.counts
totals_ns = TRACER.totals_ns
reset = TRACER.reset
innermost_at = TRACER.innermost_at
summary = TRACER.summary
report = TRACER.report
