"""Fused sparse-HDC encoder: CUDA kernel for CUDA tensors, plain version
for CPU tensors (port of ``repro.kernels.hdc_encoder.ops``)."""

from __future__ import annotations

import torch

from repro_torch.core.classifier import HDCConfig, frame_view
from repro_torch.core.im import IMParams, im_lookup_positions
from repro_torch.kernels import build
from repro_torch.kernels.common import require, use_plain
from repro_torch.kernels.hdc_encoder.ref import encoder_ref


def encoder(positions: torch.Tensor, elec: torch.Tensor, *, window: int,
            segments: int, seg_len: int, temporal_threshold: int,
            spatial_thinning: bool = False,
            spatial_threshold: int = 1) -> torch.Tensor:
    """positions (B, F, window, C, S) uint8 bound-input item positions,
    elec (C, S) uint8 -> (B, F, D // 32) int32 packed frame HVs."""
    kw = dict(window=window, segments=segments, seg_len=seg_len,
              temporal_threshold=temporal_threshold,
              spatial_thinning=spatial_thinning,
              spatial_threshold=spatial_threshold)
    if use_plain(positions, elec):
        return encoder_ref(positions, elec, **kw)
    b, f, w, c, s = positions.shape
    if w != window or s != segments:
        raise ValueError(f"positions {tuple(positions.shape)} do not match "
                         f"window={window}, segments={segments}")
    require(positions, "positions", torch.uint8)
    require(elec, "elec", torch.uint8, (c, s))
    dim = segments * seg_len
    if dim % 32:
        raise ValueError(f"D={dim} must be a multiple of 32")
    out = torch.empty((b, f, dim // 32), dtype=torch.int32,
                      device=positions.device)
    if out.numel() == 0:
        return out
    err = build.lib().hdc_encoder_launch(
        positions.data_ptr(), elec.data_ptr(), out.data_ptr(), b * f, window,
        c, s, seg_len, int(temporal_threshold), int(bool(spatial_thinning)),
        int(spatial_threshold), build.stream_ptr(positions))
    build.check(err, "hdc_encoder")
    encoder.launches += 1
    return out


encoder.launches = 0


def encode_frames_fused(params: IMParams, codes: torch.Tensor,
                        cfg: HDCConfig) -> torch.Tensor:
    """(B, T, C) uint8 codes -> (B, F, W) int32 frame HVs through the
    encoder kernel; the IM gather runs before it as a tensor gather."""
    pos = im_lookup_positions(params, frame_view(codes, cfg.window))
    return encoder(pos.contiguous(), params.elec_pos, window=cfg.window,
                   segments=cfg.segments, seg_len=cfg.seg_len,
                   temporal_threshold=cfg.temporal_threshold,
                   spatial_thinning=cfg.spatial_thinning,
                   spatial_threshold=cfg.spatial_threshold)
