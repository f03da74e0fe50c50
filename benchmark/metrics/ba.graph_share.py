"""Share (%) of the keyframe step's update rounds in the traced window
whose dense BA replayed a CUDA graph: the program's spans `ba.replay`
over its spans `round.ba`.  0 where rounds ran and none replayed (the
graph did not engage); None where no round was recorded, or where the
program has no graphed BA (`droid_slam_tpu_torch.ops.dba_static`) and so
no such span."""

import importlib.util

from benchmark.lib.program_trace import tracer

GRAPHED_BA = "droid_slam_tpu_torch.ops.dba_static"


def read(rec):
    t = tracer()
    if t is None or importlib.util.find_spec(GRAPHED_BA) is None:
        return None
    counts = t.counts()
    rounds = counts.get("round.ba")
    return 100.0 * counts.get("ba.replay", 0) / rounds if rounds else None
