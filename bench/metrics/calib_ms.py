"""Device ms per onboarding job of the work that
``HDCPipeline.calibrate_density`` launched (the calibration's plain
datapath: frame counts, sort, quantile), from the trace: every device event
whose launch lies in the harness's ``calibrate`` span."""


def read(run):
    s = run.summary
    if s is None or run.kind != "onboard" or not run.data.get("jobs"):
        return None
    secs = s.span_device_s.get("bench.calibrate", 0.0)
    if secs <= 0:
        return None
    return secs / run.data["jobs"] * 1e3
