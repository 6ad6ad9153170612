"""Item memories (port of ``repro.core.im``).

* CompIM (sparse datapaths): per channel and LBP code, the segment
  positions of a sparse segmented HV, ``(channels, codes, S)`` uint8, and
  the electrode (channel-identity) HVs as ``(channels, S)`` uint8.  The
  naive bit-domain datapath reads the same codebooks packed,
  ``(channels, codes, W)``, derived from the positions.
* Dense IM (the dense-HDC comparison system): random p = 0.5 packed HVs,
  ``(channels, codes, W)`` and ``(channels, W)``.

Packed words are int32 carrying the reference's uint32 bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import hv


@dataclass(frozen=True)
class IMParams:
    """Design-time random codebooks of the sparse datapaths (position
    domain).  The packed tables are derived from the positions; the naive
    datapath keeps them precomputed in the caches, and an ``IMParams``
    without caches derives them on access."""
    item_pos: torch.Tensor    # (channels, codes, S) uint8
    elec_pos: torch.Tensor    # (channels, S) uint8
    dim: int
    segments: int
    item_packed_cache: torch.Tensor | None = None   # (channels, codes, W) int32
    elec_packed_cache: torch.Tensor | None = None   # (channels, W) int32

    @property
    def seg_len(self) -> int:
        return self.dim // self.segments

    @property
    def device(self) -> torch.device:
        return self.item_pos.device

    @property
    def item_packed(self) -> torch.Tensor:
        """(channels, codes, W): the naive (uncompressed) IM contents."""
        if self.item_packed_cache is not None:
            return self.item_packed_cache
        return hv.positions_to_packed(self.item_pos, self.dim, self.segments)

    @property
    def elec_packed(self) -> torch.Tensor:
        if self.elec_packed_cache is not None:
            return self.elec_packed_cache
        return hv.positions_to_packed(self.elec_pos, self.dim, self.segments)

    def with_packed(self, on: bool) -> "IMParams":
        """These codebooks with the packed caches computed (``on``) or
        dropped."""
        if on:
            return IMParams(self.item_pos, self.elec_pos, self.dim,
                            self.segments, self.item_packed, self.elec_packed)
        return IMParams(self.item_pos, self.elec_pos, self.dim, self.segments)

    def to(self, device) -> "IMParams":
        def move(t):
            return None if t is None else t.to(device)

        return IMParams(self.item_pos.to(device), self.elec_pos.to(device),
                        self.dim, self.segments, move(self.item_packed_cache),
                        move(self.elec_packed_cache))


@dataclass(frozen=True)
class DenseIMParams:
    """Random p = 0.5 packed codebooks of the dense-HDC datapath."""
    item_packed: torch.Tensor   # (channels, codes, W) int32
    elec_packed: torch.Tensor   # (channels, W) int32
    dim: int

    @property
    def device(self) -> torch.device:
        return self.item_packed.device

    def to(self, device) -> "DenseIMParams":
        return DenseIMParams(self.item_packed.to(device),
                             self.elec_packed.to(device), self.dim)


def make_im(generator: torch.Generator, *, channels: int, codes: int,
            dim: int, segments: int, device,
            precompute_packed: bool = True) -> IMParams:
    """Draw the codebooks from ``generator`` (on the generator's device)
    and place them on ``device``.  The draws differ from ``jax.random``'s:
    parity with the reference transfers codebooks (``repro_torch.convert``)
    instead of redrawing them.  ``precompute_packed=False`` skips the packed
    caches, which only the naive datapath reads."""
    seg_len = dim // segments
    gdev = generator.device
    item = torch.randint(0, seg_len, (channels, codes, segments),
                         generator=generator, device=gdev, dtype=torch.int64)
    elec = torch.randint(0, seg_len, (channels, segments),
                         generator=generator, device=gdev, dtype=torch.int64)
    params = IMParams(item_pos=item.to(torch.uint8).to(device),
                      elec_pos=elec.to(torch.uint8).to(device),
                      dim=dim, segments=segments)
    return params.with_packed(precompute_packed)


def make_dense_im(generator: torch.Generator, *, channels: int, codes: int,
                  dim: int, device) -> DenseIMParams:
    """Draw dense codebooks from ``generator`` and place them on
    ``device``."""
    item = hv.random_dense_packed(generator, (channels, codes), dim)
    elec = hv.random_dense_packed(generator, (channels,), dim)
    return DenseIMParams(item_packed=item.to(device),
                         elec_packed=elec.to(device), dim=dim)


def _clamped(codes: torch.Tensor, n_codes: int) -> torch.Tensor:
    """Out-of-alphabet codes clamp to the last code, as the reference's
    gather does."""
    return torch.clamp(codes.to(torch.int64), max=n_codes - 1)


def im_lookup_packed(im, codes: torch.Tensor) -> torch.Tensor:
    """Packed IM (naive or dense): (..., channels) codes -> (..., channels,
    W) int32 HVs."""
    table = im.item_packed
    channels, n_codes = table.shape[:2]
    ch = torch.arange(channels, device=codes.device)
    return table[ch, _clamped(codes, n_codes)]


def im_lookup_positions(im: IMParams, codes: torch.Tensor) -> torch.Tensor:
    """CompIM: (..., channels) codes -> (..., channels, S) uint8 positions."""
    channels, n_codes = im.item_pos.shape[:2]
    ch = torch.arange(channels, device=codes.device)
    return im.item_pos[ch, _clamped(codes, n_codes)]
