"""Device ms per onboarding job of the work launched inside the program's
``repro_torch.calibrate.counts`` span (``classifier.with_density_target``
around ``frame_counts``: the position-domain spatial bundle and the
temporal counts), from the trace."""

from bench import program_trace


def read(run):
    return program_trace.per_job(run, "repro_torch.calibrate.counts", "device_s", 1e3)
