"""The share of the traced review window in which the card ran nothing, in %."""

from bench.metrics_common import idle_pct


def read(run):
    return idle_pct(run, "review")
