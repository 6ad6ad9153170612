"""CompIM binding (port of ``repro.core.binding.bind_positions``).

For one-bit-per-segment HVs, segmented-shift binding is a modular add of
positions: ``shift(onehot(p_a), p_b) == onehot((p_a + p_b) mod L)``.
"""

from __future__ import annotations

import torch


def bind_positions(data_pos: torch.Tensor, elec_pos: torch.Tensor,
                   seg_len: int) -> torch.Tensor:
    """(..., S) + (..., S) -> (..., S) uint8, mod ``seg_len`` adds."""
    return ((data_pos.to(torch.int32) + elec_pos.to(torch.int32))
            % seg_len).to(torch.uint8)
