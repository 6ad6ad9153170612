"""LBP preprocessing: CUDA kernel for CUDA tensors, plain version for CPU
tensors (port of ``repro.kernels.lbp.ops``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import plain, require, use_plain
from repro_torch.kernels.lbp.ref import lbp_ref
from repro_torch.runtime.spans import span


def lbp_codes(x: torch.Tensor, *, bits: int = 6) -> torch.Tensor:
    """x: (B, T, C) float32 raw signal -> (B, T - bits, C) uint8 LBP codes."""
    with span("lbp"):
        if x.ndim != 3 or x.shape[1] <= bits:
            raise ValueError(f"x must be (B, T > {bits}, C), got {tuple(x.shape)}")
        if not 1 <= bits <= 8:
            raise ValueError(f"bits={bits} must be in [1, 8]")
        if use_plain(x):
            return plain("lbp", lbp_ref, x, bits=bits)
        require(x, "x", torch.float32)
        b, t, c = x.shape
        out = torch.empty((b, t - bits, c), dtype=torch.uint8, device=x.device)
        err = build.lib().lbp_codes_launch(x.data_ptr(), out.data_ptr(), b, t, c,
                                           bits, build.stream_ptr(x))
        build.check(err, "lbp_codes")
        lbp_codes.launches += 1
        return out


lbp_codes.launches = 0
