"""Model FLOPs of the tracking window (encoders, update operator, GraphAgg,
correlation volumes once per keyframe step, the gate's taps; from the
shapes of the calls observed) over the traced window, as a share (%) of
the bf16 peak, 989 TFLOP/s."""

from benchmark.lib.readers import mfu_percent


def read(rec):
    return mfu_percent(rec)
