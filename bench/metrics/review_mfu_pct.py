"""The whole review request's share of the card's peak, in %: the least
time of the work of every request the window finished (signal, codebooks
and class HVs read once, scores and predictions written once; LBP and
encoder operations), at HBM bandwidth or the 32-bit integer and logic
rate, over the window.  The copy to the card is not the card's work and
adds nothing here: ``h2d_roofline`` reads it."""

from bench.metrics_common import mfu_pct


def read(run):
    return mfu_pct(run, "review")
