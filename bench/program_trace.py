"""The program's own spans in a traced run: the ``repro_torch.*`` ranges
that ``repro_torch.runtime.spans`` opens while the profiler records, read
from the same Chrome trace as ``bench/trace_summary.py`` reads.

By span name, over the traced window (``bench.window``):

- calls and host seconds: the ranges that start in the window;
- device seconds, device operations (kernels, copies, fills) and
  device-to-host copies: each device event is put down to the innermost
  program span open on the thread of its runtime call (the two share a
  correlation id) when that call was made;
- idle seconds: each gap in which the device ran nothing is put down to the
  innermost program span open as the gap starts.

A device event or gap under no program span is counted nowhere here.
Ranges nest on one thread: the innermost range open at a time is the
nearest, walking up the enclosing ranges from the last one started by
then, that has not ended.

The harness summarises its trace with ``trace_summary`` and hands the
readers only that summary, and a profile's Chrome trace can be saved once.
So ``of`` reads the same events from the harness's profiler, found on the
caller's stack, as the profiler's own event list (``kineto_results``), and
keeps the result on that profiler for the other readers of the run.
"""

from __future__ import annotations

import bisect
import sys
from dataclasses import dataclass

import torch

from bench.trace_summary import DEVICE_CATS, HOST_CATS, WINDOW

PREFIX = "repro_torch."


@dataclass
class SpanStats:
    calls: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    device_ops: int = 0
    d2h: int = 0
    idle_s: float = 0.0


class _Nest:
    """The nested ranges of one thread, looked up by time."""

    def __init__(self, ranges: list[tuple[float, float, str]]):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.parent, stack = [], []
        for i, (_, end, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < end:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> tuple[float, float, str] | None:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ranges[i][1] < t:
            i = self.parent[i]
        return self.ranges[i] if i >= 0 else None


def _gaps(intervals: list[tuple[float, float]], w0: float, w1: float) -> list:
    """The stretches of [w0, w1] that no interval covers."""
    out, last = [], w0
    for a, b in sorted(intervals):
        if a > last:
            out.append((last, a))
        last = max(last, b)
    if w1 > last:
        out.append((last, w1))
    return out


def summarize_events(events: list[dict]) -> dict[str, SpanStats] | None:
    """``SpanStats`` by program span name; None when the trace holds no
    window."""
    window = None
    ranges: dict[object, list] = {}
    device, launch = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = e.get("name", "")
        if cat == "user_annotation":
            if name == WINDOW:
                window = (ts, ts + dur)
            elif name.startswith(PREFIX):
                ranges.setdefault(e.get("tid"), []).append((ts, ts + dur, name))
        elif cat in DEVICE_CATS:
            d2h = cat == "gpu_memcpy" and "DtoH" in name
            device.append((ts, dur, (e.get("args") or {}).get("correlation"), d2h))
        elif cat in HOST_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (e.get("tid"), ts)
    if window is None:
        return None
    w0, w1 = window
    nests = {tid: _Nest(r) for tid, r in ranges.items()}
    out: dict[str, SpanStats] = {}
    for nest in nests.values():
        for a, b, name in nest.ranges:
            if w0 <= a <= w1:
                s = out.setdefault(name, SpanStats())
                s.calls += 1
                s.host_s += (b - a) / 1e6
    intervals = []
    for ts, dur, corr, d2h in device:
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        intervals.append((a, b))
        if corr not in launch:
            continue
        tid, t = launch[corr]
        r = nests[tid].at(t) if tid in nests else None
        if r is None:
            continue
        s = out.setdefault(r[2], SpanStats())
        s.device_s += dur / 1e6
        s.device_ops += 1
        s.d2h += d2h
    for a, b in _gaps(intervals, w0, w1):
        open_ = [r for r in (n.at(a) for n in nests.values()) if r is not None]
        if open_:
            s = out.setdefault(max(open_)[2], SpanStats())
            s.idle_s += (b - a) / 1e6
    return out


def _profile_on_stack():
    """The ``torch.profiler`` profile that a caller up the stack holds in a
    local variable (the harness's run, which calls the readers)."""
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def profiler_events(prof) -> list[dict]:
    """The finished profile's events as the Chrome trace gives those read
    here: host ranges (``user_annotation``), device events (kernels,
    copies, fills) and the CUDA runtime and driver calls that launched
    them, each with its correlation id; times in microseconds from the
    first event (the clock's own nanoseconds exceed a double's integers)."""
    cuda = torch.autograd.DeviceType.CUDA
    out, base = [], None
    for e in prof.profiler.kineto_results.events():
        name, on_card = e.name(), e.device_type() == cuda
        if e.is_user_annotation():
            if on_card:
                continue          # the range's device-side copy
            cat = "user_annotation"
        elif on_card:
            cat = ("gpu_memcpy" if name.startswith("Memcpy")
                   else "gpu_memset" if name.startswith("Memset") else "kernel")
        elif name.startswith("cu"):
            cat = "cuda_runtime"  # cudaLaunchKernel, cudaMemcpyAsync, cuLaunchKernel
        else:
            continue              # an operator: its correlation ids are its own
        t = e.start_ns()
        base = t if base is None else base
        out.append({"ph": "X", "cat": cat, "name": name, "ts": (t - base) / 1e3,
                    "dur": e.duration_ns() / 1e3, "tid": e.start_thread_id(),
                    "args": {"correlation": e.correlation_id()}})
    return out


def of(run) -> dict[str, SpanStats] | None:
    """The program's spans in the traced run ``run``, from the profiler
    that recorded it; None untraced or where no profiler is found."""
    if run.summary is None:
        return None
    prof = _profile_on_stack()
    if prof is None:
        return None
    if "_bench_program" not in prof.__dict__:
        prof._bench_program = summarize_events(profiler_events(prof))
    return prof._bench_program


def per_job(run, root: str, field: str, scale: float = 1.0):
    """The sum of ``field`` over span ``root`` and the spans inside it (by
    name: ``root`` and ``root.*``) a job of an onboarding run, times
    ``scale``.  Nothing in another kind of cell, where the trace holds no
    device event, or where the window holds no call of those spans."""
    if run.kind != "onboard" or not run.data.get("jobs"):
        return None
    if run.summary is None or run.summary.busy_s <= 0:
        return None
    stats = [s for n, s in (of(run) or {}).items()
             if n == root or n.startswith(root + ".")]
    if not any(s.calls for s in stats):
        return None
    return sum(getattr(s, field) for s in stats) / run.data["jobs"] * scale


def host_ms(run, name: str) -> float | None:
    """Mean host ms of the calls of span ``name`` in the window."""
    s = (of(run) or {}).get(name)
    if s is None or not s.calls:
        return None
    return s.host_s / s.calls * 1e3
