"""Item memory (CompIM) for the sparse datapath (port of ``repro.core.im``).

The CompIM keeps, per channel and LBP code, the segment positions of a
sparse segmented HV: ``(channels, codes, S)`` uint8.  The electrode
(channel-identity) HVs are ``(channels, S)`` uint8 positions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class IMParams:
    """Design-time random codebooks (position domain)."""
    item_pos: torch.Tensor    # (channels, codes, S) uint8
    elec_pos: torch.Tensor    # (channels, S) uint8
    dim: int
    segments: int

    @property
    def seg_len(self) -> int:
        return self.dim // self.segments

    def to(self, device) -> "IMParams":
        return IMParams(self.item_pos.to(device), self.elec_pos.to(device),
                        self.dim, self.segments)


def make_im(generator: torch.Generator, *, channels: int, codes: int,
            dim: int, segments: int, device) -> IMParams:
    """Draw the codebooks from ``generator`` (on the generator's device)
    and place them on ``device``.  The draws differ from ``jax.random``'s:
    parity with the reference transfers codebooks (``repro_torch.convert``)
    instead of redrawing them."""
    seg_len = dim // segments
    gdev = generator.device
    item = torch.randint(0, seg_len, (channels, codes, segments),
                         generator=generator, device=gdev, dtype=torch.int64)
    elec = torch.randint(0, seg_len, (channels, segments),
                         generator=generator, device=gdev, dtype=torch.int64)
    return IMParams(item_pos=item.to(torch.uint8).to(device),
                    elec_pos=elec.to(torch.uint8).to(device),
                    dim=dim, segments=segments)


def im_lookup_positions(im: IMParams, codes: torch.Tensor) -> torch.Tensor:
    """CompIM: (..., channels) codes -> (..., channels, S) uint8 positions.
    Out-of-alphabet codes clamp to the last code, as the reference's
    gather does."""
    channels, n_codes = im.item_pos.shape[:2]
    ch = torch.arange(channels, device=codes.device)
    return im.item_pos[ch, torch.clamp(codes.to(torch.int64), max=n_codes - 1)]
