"""The training lookup kernels (csrc/corr_lookup_level.cu, forward and
gradient): the least bytes of every launch in the traced window at 3.35
TB/s over their summed device time, as a share (%)."""

from benchmark.lib.readers import roofline_percent


def read(rec):
    return roofline_percent(rec, ("lookup_level_fwd_kernel", "lookup_level_bwd_kernel"))
