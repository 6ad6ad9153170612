"""Device operations (kernels, copies, fills) per onboarding job launched
inside the program's spans (``repro_torch.*``), from the trace."""

from bench import program_trace


def read(run):
    return program_trace.per_job(run, "repro_torch", "device_ops")
