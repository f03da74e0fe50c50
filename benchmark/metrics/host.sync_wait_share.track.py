"""Share (%) of the traced tracking window the host spent inside the
program's sync sites (spans `sync.*`, host clock): waiting for the stream
rather than launching."""

from benchmark.lib.program_trace import span_ns, window_percent


def read(rec):
    return window_percent(rec, span_ns(prefix="sync."))
