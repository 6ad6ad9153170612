"""Plain PyTorch version of the fused sparse-HDC encoder kernel (the
unfused core datapath)."""

from __future__ import annotations

import torch

from repro_torch.core import binding, bundling


def encoder_ref(positions: torch.Tensor, elec: torch.Tensor, *, window: int,
                segments: int, seg_len: int, temporal_threshold: int,
                spatial_thinning: bool = False,
                spatial_threshold: int = 1) -> torch.Tensor:
    """positions (B, F, window, C, S) uint8, elec (C, S) uint8 ->
    (B, F, D // 32) int32 packed frame HVs."""
    dim = segments * seg_len
    bound = binding.bind_positions(positions, elec, seg_len)
    if spatial_thinning:
        spat = bundling.spatial_bundle_thinned_positions(
            bound, dim, segments, spatial_threshold)
    else:
        spat = bundling.spatial_bundle_or_positions(bound, dim, segments)
    return bundling.temporal_bundle(spat, dim, temporal_threshold)
