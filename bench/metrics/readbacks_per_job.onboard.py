"""Device-to-host copies per onboarding job launched inside the program's
spans (``repro_torch.*``: the label check's and calibration's read-backs;
not the harness's copy of the bank), from the trace."""

from bench import program_trace


def read(run):
    return program_trace.per_job(run, "repro_torch", "d2h")
