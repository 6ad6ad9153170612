"""Fused sparse-HDC encoder: CUDA kernel for CUDA tensors, plain version
for CPU tensors (port of ``repro.kernels.hdc_encoder.ops``).

The TPU kernel takes the item positions already gathered; the CUDA kernel
takes the frame-viewed codes and the CompIM table and gathers itself, so
the (..., window, C, S) position tensor is never materialised on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.classifier import HDCConfig, frame_view
from repro_torch.core.im import IMParams
from repro_torch.kernels import build
from repro_torch.kernels.common import require, use_plain
from repro_torch.kernels.hdc_encoder.ref import encoder_plain


def encoder(codes: torch.Tensor, item_pos: torch.Tensor, elec: torch.Tensor,
            *, window: int, segments: int, seg_len: int,
            temporal_threshold: int, spatial_thinning: bool = False,
            spatial_threshold: int = 1) -> torch.Tensor:
    """codes (..., window, C) uint8 frame-viewed LBP codes, item_pos
    (C, K, S) uint8 CompIM positions, elec (C, S) uint8 -> (..., D // 32)
    int32 packed frame HVs."""
    kw = dict(window=window, segments=segments, seg_len=seg_len,
              temporal_threshold=temporal_threshold,
              spatial_thinning=spatial_thinning,
              spatial_threshold=spatial_threshold)
    if use_plain(codes, item_pos, elec):
        return encoder_plain(codes, item_pos, elec, **kw)
    *lead, win, c = codes.shape
    if win != window:
        raise ValueError(f"codes {tuple(codes.shape)} do not match "
                         f"window={window}")
    require(codes, "codes", torch.uint8)
    require(item_pos, "item_pos", torch.uint8, (c, None, segments))
    require(elec, "elec", torch.uint8, (c, segments))
    dim = segments * seg_len
    if dim % 32 or not 1 <= seg_len <= 256:
        raise ValueError(f"D={dim} must be a multiple of 32 and seg_len="
                         f"{seg_len} in [1, 256]")
    out = torch.empty((*lead, dim // 32), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    err = build.lib().hdc_encoder_launch(
        codes.data_ptr(), item_pos.data_ptr(), elec.data_ptr(), out.data_ptr(),
        math.prod(lead), window, c, item_pos.shape[1], segments, seg_len,
        int(temporal_threshold), int(bool(spatial_thinning)),
        int(spatial_threshold), build.stream_ptr(codes))
    build.check(err, "hdc_encoder")
    encoder.launches += 1
    return out


encoder.launches = 0


def encode_frames_fused(params: IMParams, codes: torch.Tensor,
                        cfg: HDCConfig) -> torch.Tensor:
    """(B, T, C) uint8 codes -> (B, F, W) int32 frame HVs through the
    encoder kernel, which gathers the CompIM positions itself."""
    return encoder(frame_view(codes, cfg.window).contiguous(), params.item_pos,
                   params.elec_pos, window=cfg.window, segments=cfg.segments,
                   seg_len=cfg.seg_len,
                   temporal_threshold=cfg.temporal_threshold,
                   spatial_thinning=cfg.spatial_thinning,
                   spatial_threshold=cfg.spatial_threshold)
