"""Plain PyTorch versions of the fused dense-HDC encoder kernel (port of
``repro.kernels.dense_hdc.ref``)."""

from __future__ import annotations

import torch

from repro_torch.core import am, hv
from repro_torch.kernels.hdc_am.ref import am_search_ref


def dense_encoder_ref(item_hvs: torch.Tensor, elec: torch.Tensor, *,
                      window: int, dim: int) -> torch.Tensor:
    """(..., window, C, W) gathered item HVs x (C, W) -> (..., W) int32
    through the unfused core path: XOR, channel majority, temporal
    majority."""
    bound = item_hvs ^ elec
    channels = item_hvs.shape[-2]
    scounts = hv.unpacked_counts(bound, axis=-2, dim=dim)      # (..., win, D)
    spat = hv.pack_bits((scounts * 2 > channels).to(torch.uint8))
    tcounts = hv.unpacked_counts(spat, axis=-2, dim=dim)       # (..., D)
    return hv.pack_bits((tcounts * 2 > window).to(torch.uint8))


def dense_encoder_plain(codes: torch.Tensor, item: torch.Tensor,
                        elec: torch.Tensor, *, window: int,
                        dim: int) -> torch.Tensor:
    """The kernel's function on its own operands: codes (..., window, C)
    uint8, item (C, K, W), elec (C, W) -> (..., W) int32.  The gather
    (out-of-alphabet codes clamp within their channel), then
    ``dense_encoder_ref``."""
    channels, n_codes = item.shape[:2]
    ch = torch.arange(channels, device=codes.device)
    hvs = item[ch, torch.clamp(codes.to(torch.int64), max=n_codes - 1)]
    return dense_encoder_ref(hvs, elec, window=window, dim=dim)


def encode_score_plain(codes: torch.Tensor, item: torch.Tensor,
                       elec: torch.Tensor, classes: torch.Tensor, *,
                       window: int, dim: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function with its AM epilogue: ``dense_encoder_plain``,
    then the D - Hamming scores against classes (n_classes, W) int32
    (``am_search_ref``), then ``am_predict`` -> ((..., n_classes) int32,
    (...) int32)."""
    frames = dense_encoder_plain(codes, item, elec, window=window, dim=dim)
    scores = am_search_ref(frames, classes, mode="hamming", dim=dim)
    return scores, am.am_predict(scores)
