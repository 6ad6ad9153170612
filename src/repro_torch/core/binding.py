"""Binding (port of ``repro.core.binding``).

* ``bind_positions`` — the CompIM datapath: for one-bit-per-segment HVs,
  segmented-shift binding is a modular add of positions,
  ``shift(onehot(p_a), p_b) == onehot((p_a + p_b) mod L)``.
* ``bind_segmented_packed`` — the naive datapath: the one-hot -> binary
  decoder on the packed data HV, then a barrel shift of each electrode
  segment, packed in and out.
* ``bind_xor`` — dense HDC.
"""

from __future__ import annotations

import torch

from repro_torch.core import hv


def bind_positions(data_pos: torch.Tensor, elec_pos: torch.Tensor,
                   seg_len: int) -> torch.Tensor:
    """(..., S) + (..., S) -> (..., S) uint8, mod ``seg_len`` adds."""
    return ((data_pos.to(torch.int32) + elec_pos.to(torch.int32))
            % seg_len).to(torch.uint8)


def roll_segments_bits(bits: torch.Tensor, shifts: torch.Tensor,
                       segments: int) -> torch.Tensor:
    """Circularly shift each L-bit segment of (..., D) bits by (..., S)
    shifts: out[j] = in[(j - shift) mod L]."""
    d = bits.shape[-1]
    seg_len = d // segments
    seg = bits.reshape(*bits.shape[:-1], segments, seg_len)
    idx = torch.arange(seg_len, device=bits.device)
    # torch's % on tensors takes the divisor's sign, like the reference's
    src = (idx - shifts.to(torch.int64).unsqueeze(-1)) % seg_len
    out = hv.take_along_axis32(seg, src, axis=-1)
    return out.reshape(*out.shape[:-2], d)


def bind_segmented_packed(data_packed: torch.Tensor,
                          elec_packed: torch.Tensor, dim: int,
                          segments: int) -> torch.Tensor:
    """Naive binding: data_packed (..., W) one-bit-per-segment IM output,
    elec_packed (..., W) broadcastable against it -> (..., W) int32."""
    shifts = hv.packed_to_positions(data_packed, dim, segments)  # decoder
    elec_bits = hv.unpack_bits(elec_packed, dim)
    shape = torch.broadcast_shapes(elec_bits.shape, shifts.shape[:-1] + (dim,))
    bound = roll_segments_bits(elec_bits.expand(shape), shifts, segments)
    return hv.pack_bits(bound)


def bind_xor(a_packed: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """Dense binding: bitwise XOR of packed words."""
    return a_packed ^ b_packed
