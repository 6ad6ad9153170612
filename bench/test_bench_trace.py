"""The trace reader's arithmetic on a small made-up trace."""

from bench import trace_summary

EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
    {"ph": "X", "cat": "user_annotation", "name": "bench.calibrate", "ts": 0, "dur": 30},
    {"ph": "X", "cat": "user_annotation", "name": "bench.fit", "ts": 40, "dur": 20},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 5, "dur": 1,
     "args": {"correlation": 1}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 45, "dur": 1,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "kernel", "name": "void lbp_kernel<true>(float const*)", "ts": 10,
     "dur": 20, "args": {"correlation": 1}},
    {"ph": "X", "cat": "kernel", "name": "hdc_encoder_kernel", "ts": 25, "dur": 10,
     "args": {"correlation": 2}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 70, "dur": 10,
     "args": {"correlation": 3}},
]


def test_busy_idle_and_attribution():
    s = trace_summary.summarize_events(EVENTS)
    assert s.window_s == 100e-6
    assert abs(s.busy_s - 35e-6) < 1e-12          # [10, 35] and [70, 80]
    assert s.kernel("lbp_kernel") == (20e-6, 1)
    assert s.kernel("lbp") == (0.0, 0)            # whole identifiers only
    assert abs(s.span_device_s["bench.calibrate"] - 20e-6) < 1e-12
    assert abs(s.span_device_s["bench.fit"] - 10e-6) < 1e-12
    assert abs(s.span_device_s["bench.other"] - 10e-6) < 1e-12
    gaps = s.idle_by_span
    assert abs(gaps["host:bench.calibrate"] - 10e-6) < 1e-12   # [0, 10]
    assert abs(gaps["host:bench.other"] - 55e-6) < 1e-12       # [35, 70] and [80, 100]
    b = s.breakdown()
    assert b["device_ops"][0][0].startswith("void lbp_kernel")
    assert len(b["idle_gaps"]) == 2


def test_a_trace_without_a_window_gives_nothing():
    assert trace_summary.summarize_events(EVENTS[1:]) is None


def test_the_copy_share_reads_the_host_to_card_copies():
    from bench import roofline
    from bench.harness import RunData
    from bench.metrics_common import h2d_share

    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 0,
         "dur": 40},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 50,
         "dur": 40},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 95,
         "dur": 5},
    ]
    s = trace_summary.summarize_events(events)
    n_bytes = roofline.H2D_BW * 30e-6          # each copy 30 us at the link's peak
    run = RunData({"kind": "review", "launches": {"h2d": [(n_bytes, 0)] * 2}}, s)
    assert abs(h2d_share(run) - 75.0) < 1e-9
    # fewer copies in the trace than the loop issued: nothing to read
    run = RunData({"kind": "review", "launches": {"h2d": [(n_bytes, 0)] * 3}}, s)
    assert h2d_share(run) is None
