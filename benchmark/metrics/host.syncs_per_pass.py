"""Host waits for the stream (the program's sync sites) in the traced
training window per accumulate pass completed: the unrolled forward and
backward, and the step's graph, batch upload and log spread over its
passes."""

from benchmark.lib.program_trace import sync_count


def read(rec):
    n, passes = sync_count(), rec["passes"]
    return n / passes if n and passes else None
