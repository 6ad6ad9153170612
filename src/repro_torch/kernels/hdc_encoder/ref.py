"""Plain PyTorch versions of the fused sparse-HDC encoder kernel (the
unfused core datapath), with and without its AM epilogue."""

from __future__ import annotations

import torch

from repro_torch.core import am, binding, bundling
from repro_torch.core.im import IMParams, im_lookup_positions
from repro_torch.kernels.hdc_am.ref import am_search_ref


def encoder_ref(positions: torch.Tensor, elec: torch.Tensor, *, window: int,
                segments: int, seg_len: int, temporal_threshold: int,
                spatial_thinning: bool = False,
                spatial_threshold: int = 1) -> torch.Tensor:
    """positions (..., window, C, S) uint8, elec (C, S) uint8 ->
    (..., D // 32) int32 packed frame HVs (port of the reference's
    ``encoder_ref``)."""
    dim = segments * seg_len
    bound = binding.bind_positions(positions, elec, seg_len)
    if spatial_thinning:
        spat = bundling.spatial_bundle_thinned_positions(
            bound, dim, segments, spatial_threshold)
    else:
        spat = bundling.spatial_bundle_or_positions(bound, dim, segments)
    return bundling.temporal_bundle(spat, dim, temporal_threshold)


def encoder_plain(codes: torch.Tensor, item_pos: torch.Tensor,
                  elec: torch.Tensor, *, window: int, segments: int,
                  seg_len: int, temporal_threshold: int,
                  spatial_thinning: bool = False,
                  spatial_threshold: int = 1) -> torch.Tensor:
    """The kernel's function on its own operands: codes (..., window, C)
    uint8, item_pos (C, K, S) uint8, elec (C, S) uint8 -> (..., D // 32)
    int32.  The CompIM gather (out-of-alphabet codes clamp to K - 1), then
    ``encoder_ref``."""
    params = IMParams(item_pos, elec, segments * seg_len, segments)
    return encoder_ref(im_lookup_positions(params, codes), elec, window=window,
                       segments=segments, seg_len=seg_len,
                       temporal_threshold=temporal_threshold,
                       spatial_thinning=spatial_thinning,
                       spatial_threshold=spatial_threshold)


def encode_score_plain(codes: torch.Tensor, item_pos: torch.Tensor,
                       elec: torch.Tensor, classes: torch.Tensor, *,
                       window: int, segments: int, seg_len: int,
                       temporal_threshold: int, spatial_thinning: bool = False,
                       spatial_threshold: int = 1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function with its AM epilogue: ``encoder_plain``, then
    the overlap scores against classes (n_classes, D // 32) int32
    (``am_search_ref``), then ``am_predict`` -> ((..., n_classes) int32,
    (...) int32)."""
    frames = encoder_plain(codes, item_pos, elec, window=window,
                           segments=segments, seg_len=seg_len,
                           temporal_threshold=temporal_threshold,
                           spatial_thinning=spatial_thinning,
                           spatial_threshold=spatial_threshold)
    scores = am_search_ref(frames, classes, mode="overlap",
                           dim=segments * seg_len)
    return scores, am.am_predict(scores)
