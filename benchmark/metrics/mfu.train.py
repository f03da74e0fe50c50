"""Model FLOPs of the training window (per pass: encoders on every frame,
level-0 volumes of the real edges, the unrolled update operator with
GraphAgg and upsampling; the backward counted as twice the forward) over
the traced window, as a share (%) of the f32 peak, 67 TFLOP/s."""

from benchmark.lib.readers import mfu_percent


def read(rec):
    return mfu_percent(rec)
