"""Share of the host link's bandwidth that the review request's copy of its
recording to the card reached in the traced window, in %: the recordings'
bytes over the device time of the host-to-card copies."""

from bench.metrics_common import h2d_share


def read(run):
    if run.kind != "review":
        return None
    return h2d_share(run)
