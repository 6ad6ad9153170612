"""Plain PyTorch version of the LBP kernel."""

from __future__ import annotations

import torch


def lbp_ref(x: torch.Tensor, *, bits: int = 6) -> torch.Tensor:
    """x: (B, T, C) float -> (B, T - bits, C) uint8:
    code[t] = sum_i 2^i * [x[t + bits - i] > x[t + bits - i - 1]]."""
    d = (x[:, 1:] > x[:, :-1]).to(torch.int32)
    t_out = d.shape[1] - bits + 1
    code = torch.zeros((x.shape[0], t_out, x.shape[2]), dtype=torch.int32,
                       device=x.device)
    for i in range(bits):
        code |= d[:, bits - 1 - i: bits - 1 - i + t_out] << i
    return code.to(torch.uint8)
