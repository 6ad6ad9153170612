"""Mean host ms of one epoch of ``fit_iterative`` (the program's
``repro_torch.fit.epoch`` span: class HVs from the counter file, the AM
search, the gated update, each issued)."""

from bench import program_trace


def read(run):
    if run.kind != "onboard":
        return None
    return program_trace.host_ms(run, "repro_torch.fit.epoch")
