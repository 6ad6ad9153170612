"""Arithmetic the per-layer readers (``bench/metrics/*.py``) share."""

from __future__ import annotations

from bench import roofline


def roofline_share(run, kernel: str):
    """The least time of every launch of ``kernel`` in the traced window
    (``bench/roofline.py``) over the device time of its events, in %.
    Nothing when the trace holds none of them, or holds another number of
    launches than the loop issued."""
    launches = run.data.get("launches", {}).get(kernel)
    if run.summary is None or not launches:
        return None
    secs, n = run.summary.kernel(roofline.KERNEL_NAMES[kernel])
    if n != len(launches) or secs <= 0:
        return None
    return 100.0 * sum(roofline.bound_s(b, o) for b, o in launches) / secs


def h2d_share(run):
    """The bytes the loop copied from host memory to the card in the traced
    window over the device time of the trace's host-to-card copies, as a
    share of the link's bandwidth (``bench/roofline.py``), in %.  Nothing
    when the trace holds fewer such copies than the loop issued."""
    copies = run.data.get("launches", {}).get("h2d")
    if run.summary is None or not copies:
        return None
    secs, n = run.summary.kernel(roofline.H2D_NAME)
    if n < len(copies) or secs <= 0:
        return None
    return 100.0 * sum(b for b, _ in copies) / roofline.H2D_BW / secs


def idle_pct(run, kind: str):
    """The share of the traced window in which no operation ran on the
    device, in %."""
    s = run.summary
    if s is None or run.kind != kind or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu_pct(run, kind: str):
    """The least time of the work the window finished (``bench/roofline.py``)
    over the window, in %."""
    if run.kind != kind or run.data.get("bound_s_in_window", 0) <= 0:
        return None
    return 100.0 * run.data["bound_s_in_window"] / run.data["window_s"]
