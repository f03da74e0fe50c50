"""Share (%) of the traced training window the trainer spent preparing
steps (the program's spans `train.draw`, `train.graph` and `train.batch`:
drawing a batch, choosing its frame graph, uploading it)."""

from benchmark.lib.program_trace import span_ns, window_percent


def read(rec):
    return window_percent(rec, span_ns("train.draw", "train.graph",
                                       "train.batch"))
