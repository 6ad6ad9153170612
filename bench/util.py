"""Small pieces the loops share: device waits, host spans, pinned buffers."""

from __future__ import annotations

import contextlib
import time

import torch


class Done:
    """A point on the device's stream that the host can wait for; on the
    CPU the work is already done when the call returns."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host buffer the device copies into without blocking (pinned on a
    card)."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def to_host(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host copy of ``x`` that the card reads back without blocking
    (pinned on a card): where an archive's recordings wait between jobs."""
    return host_buffer(x.shape, x.dtype, device).copy_(x)


def stream(device: torch.device):
    """A stream of its own on a card, where copies and kernels of one
    request queue in order while another request's run beside them; None
    on the CPU."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def on(s) -> contextlib.AbstractContextManager:
    """Work issued inside runs on stream ``s`` (a no-op for None)."""
    return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()


def follow(s_to, s_from, *tensors) -> None:
    """Stream ``s_to`` waits for the work queued so far on ``s_from``, and
    ``tensors``, made there, stay allocated until ``s_to`` is done with
    them (a no-op on the CPU)."""
    if s_to is None:
        return
    s_to.wait_stream(s_from)
    for t in tensors:
        t.record_stream(s_to)


class Spans:
    """Host spans of the benchmark's calls into the program: seconds by
    name, and a ``torch.profiler`` range of the same name when traced."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(f"bench.{name}") if self.traced
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def mean_ms(self, name: str) -> float | None:
        v = self.seconds.get(name)
        return sum(v) / len(v) * 1e3 if v else None
