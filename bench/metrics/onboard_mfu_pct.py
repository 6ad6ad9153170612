"""The whole onboarding job's share of the card's peak, in %: the least
time of the work of every job the window finished (``roofline.onboard_work``)
over the window."""

from bench.metrics_common import mfu_pct


def read(run):
    return mfu_pct(run, "onboard")
