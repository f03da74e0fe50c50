"""What the program's own tracer (droid_slam_tpu_torch/utils/timers.py)
recorded in a run.  It records only while a `torch.profiler` session
records, so in a traced run (one run to a process) its records are the
traced window's.  Each function gives None where the program has no such
tracer or it recorded nothing: a reader of it then reports nothing."""


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from droid_slam_tpu_torch.utils import timers
    except ImportError:
        return None
    return timers if hasattr(timers, "totals_ns") else None


def sync_count():
    """Host waits counted by the program's sync sites, or None."""
    t = tracer()
    if t is None:
        return None
    return sum(n for k, n in t.counts().items()
               if k.startswith("sync.")) or None


def span_ns(*names, prefix=None):
    """Summed time (ns) of the spans named, or of those whose name starts
    with `prefix`; None where none was recorded."""
    t = tracer()
    if t is None:
        return None
    ns = sum(v for k, v in t.totals_ns().items()
             if k in names or (prefix is not None and k.startswith(prefix)))
    return ns or None


def mean_ms(name):
    """Mean time (ms) of the spans named `name`, or None."""
    t = tracer()
    n = t.counts().get(name) if t is not None else None
    return t.totals_ns()[name] / 1e6 / n if n else None


def window_percent(rec, ns):
    """`ns` as a share (%) of the traced window, or None."""
    return None if ns is None else 100.0 * ns / 1e9 / rec["trace"]["window_s"]
