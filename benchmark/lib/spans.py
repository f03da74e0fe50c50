"""Spans on the host clock, recorded by the benchmark around its calls
into the program's layers (wrapped on the instances at set-up)."""

import time


class Spans:
    """Closed spans as (name, start_ns, end_ns) on `time.perf_counter_ns`,
    kept in memory while `on`."""

    def __init__(self):
        self.on = False
        self.closed = []

    def wrap(self, name, fn):
        """`fn` with a span named `name` around every call."""
        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.closed.append((name, t0, time.perf_counter_ns()))
        return wrapped

    def add(self, name, t0, t1):
        if self.on:
            self.closed.append((name, t0, t1))

    def innermost_at(self, t):
        """Name of the shortest span that holds host time t, or None."""
        best = None
        for name, a, b in self.closed:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else None
