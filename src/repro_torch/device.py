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
