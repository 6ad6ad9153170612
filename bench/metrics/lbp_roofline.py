"""Share of its roofline that the LBP kernel reached in the traced window,
in %: the least time of every launch over the device time of the
``lbp_kernel`` events."""

from bench.metrics_common import roofline_share


def read(run):
    return roofline_share(run, "lbp")
