"""Mean host time (ms) of the keyframe step's update rounds in the traced
window (the program's span `keyframe.round`: correlation, update operator
and dense BA, with the host's waits inside it)."""

from benchmark.lib.program_trace import mean_ms


def read(rec):
    return mean_ms("keyframe.round")
