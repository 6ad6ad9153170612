"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU.  There
is no silent CPU fallback: without a card, ``device=None`` raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first CUDA device (raises when there is none);
    anything else is taken as given (``"cpu"`` selects the plain path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def local_devices(device_type: str) -> list[torch.device]:
    """The devices of one type this process places work on: one entry per
    CUDA card for ``"cuda"``, ``[cpu]`` for the CPU.  Capacity tiles
    round-robin over this list (``serve/fleet.py``)."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]
