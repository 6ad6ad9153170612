"""Device ms per onboarding job of the work launched inside the program's
``repro_torch.calibrate.threshold`` span (``threshold_for_density``'s sort,
quantile and read-backs, and the threshold read to the host), from the
trace."""

from bench import program_trace


def read(run):
    return program_trace.per_job(run, "repro_torch.calibrate.threshold", "device_s", 1e3)
