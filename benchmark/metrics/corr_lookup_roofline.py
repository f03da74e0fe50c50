"""The serving lookup kernel (csrc/corr_lookup.cu): least bytes of every
launch in the traced window at 3.35 TB/s over its device time, as a
share (%)."""

from benchmark.lib.readers import roofline_percent


def read(rec):
    return roofline_percent(rec, ("corr_lookup_kernel",))
