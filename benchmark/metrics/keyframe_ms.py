"""Mean latency (ms, synchronized host clock) of the window's frames that
became keyframes: the gate, the context encoder and the keyframe step."""

from benchmark.lib.readers import frame_latencies, mean


def read(rec):
    return mean(frame_latencies(rec, True))
