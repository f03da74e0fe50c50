"""Arithmetic the metric readers share, over a run's record."""

from benchmark.lib import costs


def mean(values):
    return sum(values) / len(values) if values else None


def frame_latencies(rec, keyframe):
    """Latencies (ms) of the window's frames that did (True) or did not
    (False) become keyframes."""
    return [l for l, k in zip(rec["latency_ms"], rec["keyframe"])
            if k == keyframe]


def idle_percent(rec):
    tr = rec["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_seconds(rec, names):
    """Device seconds of the kernels whose name holds one of `names`."""
    return sum(s for n, s in rec["trace"]["kernel_s"].items()
               if any(k in n for k in names))


def roofline_percent(rec, names):
    """The least time of the recorded lookups' bytes at the HBM peak over
    the device time of the kernels named; None where none ran."""
    t = kernel_seconds(rec, names)
    if not rec.get("lookup_launches") or t <= 0:
        return None
    return 100.0 * rec["lookup_bytes"] / costs.PEAK_HBM_BYTES_PER_S / t


def mfu_percent(rec):
    return (100.0 * rec["model_flops"] / rec["trace"]["window_s"]
            / rec["peak_flops"])
