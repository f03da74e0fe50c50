"""Mean latency (ms, synchronized host clock) of the window's frames that
became keyframes, in a cell whose tail is not a latency of its own: the
few keyframe steps there weigh on the frames per second."""

from benchmark.lib.readers import frame_latencies, mean


def read(rec):
    return mean(frame_latencies(rec, True))
