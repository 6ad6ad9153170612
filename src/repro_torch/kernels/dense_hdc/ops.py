"""Fused dense-HDC encoder: CUDA kernel for CUDA tensors, plain version for
CPU tensors (port of ``repro.kernels.dense_hdc.ops``).

The TPU kernel takes the item HVs already gathered; the CUDA kernel takes
the frame-viewed codes and the (C, K, W) table and gathers itself, so the
(..., window, C, W) operand is never materialised on the card.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.classifier import HDCConfig, frame_view
from repro_torch.core.im import DenseIMParams
from repro_torch.kernels import build
from repro_torch.kernels.common import require, use_plain
from repro_torch.kernels.dense_hdc.ref import dense_encoder_plain


def dense_encoder(codes: torch.Tensor, item: torch.Tensor,
                  elec: torch.Tensor, *, window: int,
                  dim: int) -> torch.Tensor:
    """codes (..., window, C) uint8 frame-viewed LBP codes, item (C, K, W)
    int32, elec (C, W) int32 -> (..., W) int32 packed frame HVs."""
    if use_plain(codes, item, elec):
        return dense_encoder_plain(codes, item, elec, window=window, dim=dim)
    *lead, win, c = codes.shape
    k, w = item.shape[1], item.shape[2]
    if win != window or w * 32 != dim:
        raise ValueError(f"codes {tuple(codes.shape)}, item "
                         f"{tuple(item.shape)} do not match window={window}, "
                         f"dim={dim}")
    require(codes, "codes", torch.uint8)
    require(item, "item", torch.int32, (c, k, w))
    require(elec, "elec", torch.int32, (c, w))
    out = torch.empty((*lead, w), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    err = build.lib().dense_hdc_launch(
        codes.data_ptr(), item.data_ptr(), elec.data_ptr(), out.data_ptr(),
        math.prod(lead), window, c, k, w, build.stream_ptr(codes))
    build.check(err, "dense_hdc")
    dense_encoder.launches += 1
    return out


dense_encoder.launches = 0


def dense_encode_frames_fused(params: DenseIMParams, codes: torch.Tensor,
                              cfg: HDCConfig) -> torch.Tensor:
    """(B, T, C) uint8 codes -> (B, F, W) int32 frame HVs through the dense
    encoder kernel."""
    return dense_encoder(frame_view(codes, cfg.window).contiguous(),
                         params.item_packed, params.elec_packed,
                         window=cfg.window, dim=cfg.dim)
