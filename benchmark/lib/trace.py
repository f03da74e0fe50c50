"""The device trace of a window: torch.profiler over CUDA activity only,
read from its raw events (no event tree), and aligned with the host clock
by a marker kernel launched at a known host time on each side of the
window."""

import time

import torch

TOP = 10


def union_s(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.host_marks = []

    def _mark(self):
        torch.cuda.synchronize(self.device)
        t = time.perf_counter_ns()
        torch.full((1,), 7.0, device=self.device)
        torch.cuda.synchronize(self.device)
        self.host_marks.append(t)

    def start(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark()

    def stop(self):
        self._mark()
        self.prof.__exit__(None, None, None)

    def events(self):
        """Device events as (name, start_ns, end_ns) on the host clock,
        between the two markers (exclusive), and the window (start_ns,
        end_ns) the markers bound."""
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            d = (e.duration_ns() if hasattr(e, "duration_ns")
                 else e.duration_us() * 1000)
            raw.append((e.name(), s, s + d))
        raw.sort(key=lambda r: r[1])
        if len(raw) < 2:
            raise RuntimeError("the profiler recorded no device events")
        first, last = raw[0], raw[-1]
        # device clock -> host clock from the opening marker
        off = first[1] - self.host_marks[0]
        evs = [(n, a - off, b - off) for n, a, b in raw[1:-1]]
        return evs, (first[2] - off, last[1] - off)


def summarize(events, window, spans):
    """Busy and window seconds, kernel seconds by name, and the breakdown:
    the device operations that took most time and the longest idle gaps,
    each gap named by the innermost benchmark span open at its middle."""
    w0, w1 = window
    clipped = [(max(a, w0), min(b, w1)) for _, a, b in events
               if b > w0 and a < w1]
    busy_ns = union_s(clipped)
    by_name = {}
    for n, a, b in events:
        s = by_name.setdefault(n, [0, 0])
        s[0] += b - a
        s[1] += 1
    gaps, end = [], w0
    for a, b in sorted(clipped):
        if a > end:
            gaps.append((a - end, end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((w1 - end, end, w1))
    gaps.sort(reverse=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return dict(
        busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
        kernel_s={n: v[0] / 1e9 for n, v in by_name.items()},
        kernel_count={n: v[1] for n, v in by_name.items()},
        launches=len(events),
        breakdown=dict(
            device_ops=[[n[:160], v[0] / 1e9] for n, v in top],
            idle_gaps=[[spans.innermost_at((a + b) // 2) or "outside spans",
                        g / 1e9] for g, a, b in gaps[:TOP]]))
