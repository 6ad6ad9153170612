"""Host ms a review request spends in the program's entry points: the mean
of the ``repro_torch.lbp`` span (``lbp_codes``: checks, allocation,
launch) plus that of ``repro_torch.infer`` (``HDCPipeline.infer`` and the
fused encoder wrapper).  The harness's copies are outside both."""

from bench import program_trace


def read(run):
    if run.kind != "review":
        return None
    lbp = program_trace.host_ms(run, "repro_torch.lbp")
    infer = program_trace.host_ms(run, "repro_torch.infer")
    if lbp is None or infer is None:
        return None
    return lbp + infer
