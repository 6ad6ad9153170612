"""Host ms per onboarding job in ``HDCPipeline.fit_iterative`` (the
harness's ``fit`` span): the label check, the encoder launch and each
epoch's kernels issued."""


def read(run):
    if run.kind != "onboard":
        return None
    return run.data["spans"].mean_ms("fit")
