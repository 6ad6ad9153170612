"""Host ms a review request spends issuing its work: the copy of the
recording to the card, the program's entry points (the LBP wrapper,
``HDCPipeline.infer``) and the copies to the host, without the wait for the
device (the harness's ``submit`` span)."""


def read(run):
    if run.kind != "review":
        return None
    return run.data["spans"].mean_ms("submit")
