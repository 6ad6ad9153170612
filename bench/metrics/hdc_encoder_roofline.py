"""Share of its roofline that the sparse encoder kernel (with its AM
epilogue) reached in the traced window, in %."""

from bench.metrics_common import roofline_share


def read(run):
    return roofline_share(run, "hdc_encoder")
