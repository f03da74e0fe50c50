"""Share (%) of the edges the update rounds of the traced window updated
that are rig edges ii == jj (the program's counters `edges.stereo` over
`edges.active`): the part of the update operator's and the lookups' work
that the second camera brings.  None where the program has no such
counters or counted no edge."""

from benchmark.lib.program_trace import tracer


def read(rec):
    t = tracer()
    counts = t.counts() if t is not None else {}
    edges = counts.get("edges.active")
    return 100.0 * counts.get("edges.stereo", 0) / edges if edges else None
