"""Reading a ``torch.profiler`` trace: device busy time, kernel time by name,
device time by the benchmark's host spans, and idle gaps by what the host
was doing.

The profiler's Chrome trace holds device events (kernels, copies, fills)
with a correlation id, the host's runtime calls with the same id, and the
benchmark's own host spans (``record_function`` names starting ``bench.``).
The spans a loop opens around its calls into the program do not overlap
one another; ``bench.window`` encloses them all and marks the traced
window.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW = "bench.window"


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)      # device name -> seconds
    kernel_n: dict = field(default_factory=dict)      # device name -> launches
    span_device_s: dict = field(default_factory=dict)  # host span -> device seconds
    idle_by_span: dict = field(default_factory=dict)   # host span -> idle seconds

    def kernel(self, short: str) -> tuple[float, int]:
        """(seconds, launches) of every device kernel whose name holds
        ``short`` as a whole identifier."""
        secs, n = 0.0, 0
        for name, s in self.kernel_s.items():
            if _holds(name, short):
                secs += s
                n += self.kernel_n[name]
        return secs, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _holds(name: str, ident: str) -> bool:
    i = name.find(ident)
    while i >= 0:
        before = name[i - 1] if i else " "
        j = i + len(ident)
        after = name[j] if j < len(name) else " "
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        i = name.find(ident, i + 1)
    return False


class _Spans:
    """Non-overlapping host spans, looked up by time."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][2]
        return None


def summarize_events(events: list[dict]) -> Summary | None:
    """The summary of one trace's events; None when it holds no window."""
    window = None
    spans, device, launch_ts = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = e.get("name", "")
        if cat == "user_annotation" and name.startswith("bench."):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, name))
        elif cat in DEVICE_CATS:
            device.append((ts, dur, name, (e.get("args") or {}).get("correlation")))
        elif cat in HOST_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = ts
    if window is None:
        return None
    w0, w1 = window
    host = _Spans(spans)
    out = Summary(window_s=(w1 - w0) / 1e6, busy_s=0.0)
    intervals = []
    for ts, dur, name, corr in device:
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        intervals.append((a, b))
        out.kernel_s[name] = out.kernel_s.get(name, 0.0) + dur / 1e6
        out.kernel_n[name] = out.kernel_n.get(name, 0) + 1
        label = host.at(launch_ts[corr]) if corr in launch_ts else None
        label = label or "bench.other"
        out.span_device_s[label] = out.span_device_s.get(label, 0.0) + dur / 1e6
    intervals.sort()
    busy, cur_a, cur_b = 0.0, None, None
    gaps = []
    last_end = w0
    for a, b in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > last_end:
                gaps.append((last_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last_end = max(last_end, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if w1 > last_end:
        gaps.append((last_end, w1))
    out.busy_s = busy / 1e6
    for a, b in gaps:
        label = "host:" + (host.at(a) or "bench.other")
        out.idle_by_span[label] = out.idle_by_span.get(label, 0.0) + (b - a) / 1e6
    return out


def summarize_file(path: str) -> Summary | None:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize_events(events)
