"""The program-span reader's arithmetic on small made-up traces, its
readers, and one traced run of each kind on the CPU through the harness."""

import dataclasses
import types

import pytest
import torch

from bench import harness, program_trace, trace_summary
from bench.conftest import SEED, TINY
from bench.harness import RunData
from bench.test_bench_trace import EVENTS as BENCH_EVENTS


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 0.1, "tid": tid, "args": {"correlation": corr}}


def _device(corr, ts, dur, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


D2H = dict(cat="gpu_memcpy", name="Memcpy DtoH (Device -> Pageable)")

# one onboarding job: calibration's two stages inside ``calibrate``, the
# label check, the encode and two epochs inside ``fit``; busy [10, 20],
# [22, 24], [25, 26], [43, 44], [46, 50], [53, 55], [59, 60], [70, 80]
EVENTS = [
    _range("bench.window", 0, 100),
    _range("bench.calibrate", 0, 30),
    _range("bench.fit", 40, 25),
    _range("repro_torch.calibrate", 1, 28),
    _range("repro_torch.calibrate.counts", 2, 18.5),
    _range("repro_torch.calibrate.threshold", 21, 7),
    _range("repro_torch.fit", 41, 20),
    _range("repro_torch.fit.labels", 42, 1.5),
    _range("repro_torch.fit.encode", 43.8, 6.7),
    _range("repro_torch.fit.epoch", 51, 4.2),
    _range("repro_torch.fit.epoch", 55.5, 2.5),
    _launch(1, 5), _device(1, 10, 10),
    _launch(2, 22), _device(2, 22, 2),
    _launch(3, 25), _device(3, 25, 1, **D2H),
    _launch(4, 42.5), _device(4, 43, 1, **D2H),
    _launch(5, 45), _device(5, 46, 4),
    _launch(6, 52), _device(6, 53, 2),
    _launch(7, 58.5), _device(7, 59, 1),                 # fit's own time
    _launch(8, 68), _device(8, 70, 10, **D2H),           # under no program span
]


def _close(a, b):
    return abs(a - b) < 1e-12


def test_device_work_and_gaps_go_to_the_innermost_span():
    p = program_trace.summarize_events(EVENTS)
    want = {  # name: (calls, host us, device us, ops, d2h, idle us)
        "repro_torch.calibrate": (1, 28, 0, 0, 0, 0),
        "repro_torch.calibrate.counts": (1, 18.5, 10, 1, 0, 2),      # [20, 22]
        "repro_torch.calibrate.threshold": (1, 7, 3, 2, 1, 18),      # [24, 25], [26, 43]
        "repro_torch.fit": (1, 20, 1, 1, 0, 10),                     # [60, 70]
        "repro_torch.fit.labels": (1, 1.5, 1, 1, 1, 0),
        "repro_torch.fit.encode": (1, 6.7, 4, 1, 0, 5),              # [44, 46], [50, 53]
        "repro_torch.fit.epoch": (2, 6.7, 2, 1, 0, 4),               # [55, 59]
    }
    assert set(p) == set(want)
    for name, (calls, host, dev, ops, d2h, idle) in want.items():
        s = p[name]
        assert (s.calls, s.device_ops, s.d2h) == (calls, ops, d2h), name
        assert _close(s.host_s, host * 1e-6), name
        assert _close(s.device_s, dev * 1e-6), name
        assert _close(s.idle_s, idle * 1e-6), name


def test_a_trace_without_a_window_gives_nothing():
    assert program_trace.summarize_events(EVENTS[1:]) is None


def test_each_thread_has_its_own_nest():
    events = EVENTS + [_range("repro_torch.lbp", 40, 30, tid=2), _launch(9, 50, tid=2),
                       _device(9, 90, 1)]
    p = program_trace.summarize_events(events)
    assert p["repro_torch.lbp"].device_ops == 1
    assert p["repro_torch.fit.epoch"].device_ops == 1
    # a gap under both threads' spans goes to the one started last
    assert _close(p["repro_torch.fit"].idle_s, 10e-6)


def test_ranges_outside_the_window_are_not_calls():
    events = EVENTS + [_range("repro_torch.infer", 120, 5)]
    assert "repro_torch.infer" not in program_trace.summarize_events(events)


def test_program_ranges_leave_the_harness_summary_as_it_was():
    extra = [_range("repro_torch.calibrate", 1, 28), _range("repro_torch.calibrate.counts", 2, 10),
             _range("repro_torch.fit", 41, 18), _range("repro_torch.fit.epoch", 44, 3),
             _range("repro_torch.lbp", 62, 30)]
    before = trace_summary.summarize_events(BENCH_EVENTS)
    after = trace_summary.summarize_events(BENCH_EVENTS + extra)
    assert dataclasses.asdict(after) == dataclasses.asdict(before)
    assert after.breakdown() == before.breakdown()
    assert set(before.breakdown()) == {"device_ops", "idle_gaps"}


class _Event:
    """One made-up event as the profiler's own event list gives it."""

    def __init__(self, e, card=None, annotation=None):
        cat = e["cat"]
        self.e = e
        self.card = cat in ("kernel", "gpu_memcpy", "gpu_memset") if card is None else card
        self.annotation = cat == "user_annotation" if annotation is None else annotation

    def name(self):
        return self.e["name"]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.card else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return 10**18 + round(self.e["ts"] * 1000)

    def duration_ns(self):
        return round(self.e["dur"] * 1000)

    def start_thread_id(self):
        return self.e.get("tid")

    def correlation_id(self):
        return (self.e.get("args") or {}).get("correlation", 0)


class _Recorded(torch.profiler.profile):
    """A finished profile whose events are the made-up ``events``, with an
    operator and each range's device-side copy beside them, as a card's
    profile has them."""

    def __init__(self, events):
        extra = []
        for e in events:
            if e["cat"] == "cuda_runtime":   # its operator, whose id may be the same
                extra.append(_Event({**e, "name": "aten::view", "ts": e["ts"] + 30},
                                    card=False, annotation=False))
            if e["cat"] == "user_annotation":
                extra.append(_Event({**e, "ts": e["ts"] + 50}, card=True))
        kineto = [_Event(e) for e in events] + extra
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: kineto))


ONBOARD = ["calib_counts_ms", "calib_threshold_ms", "fit_epoch_host_ms", "fit_idle_ms",
           "readbacks_per_job.onboard", "ops_per_job.onboard"]


def _read(events, name, data):
    prof = _Recorded(events)  # noqa: F841 -- the readers find it on the stack
    return harness.reader(name)(RunData(data, trace_summary.summarize_events(events)))


@pytest.mark.parametrize("name, jobs, want", [
    ("calib_counts_ms", 1, 10e-3), ("calib_counts_ms", 2, 5e-3),
    ("calib_threshold_ms", 1, 3e-3),
    ("fit_epoch_host_ms", 2, 3.35e-3),                     # per call, not per job
    ("fit_idle_ms", 1, 19e-3),                             # fit 10, encode 5, epochs 4
    ("readbacks_per_job.onboard", 1, 2), ("readbacks_per_job.onboard", 2, 1),
    ("ops_per_job.onboard", 1, 7),
])
def test_the_onboarding_readers(name, jobs, want):
    got = _read(EVENTS, name, {"kind": "onboard", "jobs": jobs})
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", ONBOARD)
def test_the_onboarding_readers_find_nothing_without_the_spans(name):
    bare = [e for e in EVENTS if not e["name"].startswith("repro_torch.")]
    assert _read(bare, name, {"kind": "onboard", "jobs": 1}) is None
    assert _read(EVENTS, name, {"kind": "review", "jobs": 1}) is None
    # untraced: nothing to read
    assert harness.reader(name)(RunData({"kind": "onboard", "jobs": 1}, None)) is None


def test_the_readers_cache_the_trace_on_the_profiler():
    prof = _Recorded(EVENTS)
    run = RunData({"kind": "onboard", "jobs": 1}, trace_summary.summarize_events(EVENTS))
    first = program_trace.of(run)
    prof.profiler = None
    assert program_trace.of(run) is first


def test_no_profiler_on_the_stack_gives_nothing():
    run = RunData({"kind": "onboard", "jobs": 1}, trace_summary.summarize_events(EVENTS))
    assert program_trace.of(run) is None
    assert harness.reader("ops_per_job.onboard")(run) is None


REVIEW = [
    _range("bench.window", 0, 100),
    _range("bench.submit", 0, 20), _range("repro_torch.lbp", 2, 3),
    _range("repro_torch.infer", 6, 9),
    _range("bench.submit", 50, 20), _range("repro_torch.lbp", 52, 5),
    _range("repro_torch.infer", 58, 7),
    _launch(1, 3), _device(1, 10, 30), _launch(2, 7), _device(2, 40, 20),
]


def test_the_entry_point_reader():
    got = _read(REVIEW, "entry_host_ms.review", {"kind": "review"})
    assert got == pytest.approx((3 + 5) / 2 * 1e-3 + (9 + 7) / 2 * 1e-3, rel=1e-9)
    assert _read(REVIEW, "entry_host_ms.review", {"kind": "onboard", "jobs": 1}) is None
    no_infer = [e for e in REVIEW if e["name"] != "repro_torch.infer"]
    assert _read(no_infer, "entry_host_ms.review", {"kind": "review"}) is None


@pytest.mark.parametrize("cell, present, absent", [
    ("compim.onboard", ["fit_epoch_host_ms"],
     ["calib_counts_ms", "fit_idle_ms", "ops_per_job.onboard"]),
    ("dense.review", ["entry_host_ms.review"], []),
])
def test_a_traced_run_on_the_cpu_reads_the_programs_spans(cell, present, absent):
    """On the CPU the trace holds no device event: the host spans are read,
    and no device number is written."""
    kind = "onboard" if cell.endswith("onboard") else "review"
    res = harness.run(cell, SEED + 5, 0.2, True, device="cpu", traffic_overrides=TINY[kind])
    assert res["correct"], res["checks"]
    for name in present:
        assert res["metrics"][name]["value"] > 0
    for name in absent:
        assert name not in res["metrics"]
