"""Share (%) of the keyframe step's update rounds in the traced window
whose update operator replayed a CUDA graph: the program's spans
`op.replay` over its spans `round.update_op`.  0 where rounds ran and
none replayed (no graph fitted); None where no round was recorded, or
where the program has no graphed update operator
(`droid_slam_tpu_torch.models.update_graphs`) and so no such span."""

import importlib.util

from benchmark.lib.program_trace import tracer

GRAPHED_OP = "droid_slam_tpu_torch.models.update_graphs"


def read(rec):
    t = tracer()
    if t is None or importlib.util.find_spec(GRAPHED_OP) is None:
        return None
    counts = t.counts()
    rounds = counts.get("round.update_op")
    return 100.0 * counts.get("op.replay", 0) / rounds if rounds else None
