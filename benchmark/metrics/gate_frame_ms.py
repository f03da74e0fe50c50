"""Mean latency (ms, synchronized host clock) of the window's frames that
stopped at the motion gate."""

from benchmark.lib.readers import frame_latencies, mean


def read(rec):
    return mean(frame_latencies(rec, False))
