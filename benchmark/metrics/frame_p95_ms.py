"""95th percentile of the window's frame latencies: hand-in to the return
of track plus a synchronize."""

from benchmark.lib.stats import percentile


def read(rec):
    return percentile(rec["latency_ms"], 95)
