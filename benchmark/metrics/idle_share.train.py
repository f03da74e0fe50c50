"""Share (%) of the traced training window in which no operation ran on the
device."""

from benchmark.lib.readers import idle_percent


def read(rec):
    return idle_percent(rec)
