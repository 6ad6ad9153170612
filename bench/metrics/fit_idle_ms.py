"""Card-idle ms per onboarding job in the gaps that start while the host is
inside ``fit_iterative`` (the program's ``repro_torch.fit`` span or one of
its children: the label read-back, the encode, the epochs), from the
trace."""

from bench import program_trace


def read(run):
    return program_trace.per_job(run, "repro_torch.fit", "idle_s", 1e3)
