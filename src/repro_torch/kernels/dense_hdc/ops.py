"""Fused dense-HDC encoder: CUDA kernel for CUDA tensors, plain version for
CPU tensors (port of ``repro.kernels.dense_hdc.ops``).

The TPU kernel takes the item HVs already gathered; the CUDA kernel takes
the frame-viewed codes and the (C, K, W) table and gathers itself, so the
(..., window, C, W) operand is never materialised on the card.  The
pipeline's entry points hand it the (B, T, C) code stream where it lies
(``codes[1:]`` cut to whole frames is not copied), and with the class HVs
it scores the frames itself (its AM epilogue, hamming mode):
``encode_score_fused`` is the dense pipeline's whole inference in one
launch.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.classifier import HDCConfig, frame_view
from repro_torch.core.im import DenseIMParams
from repro_torch.kernels import build
from repro_torch.kernels.common import plain, require, stream_rows, use_plain
from repro_torch.kernels.dense_hdc.ref import dense_encoder_plain, encode_score_plain


def _launch(codes, n_frames, per_row, pitch, item, elec, out, classes, scores,
            preds, *, window: int, dim: int) -> None:
    """Check the tables and classes and launch over ``n_frames`` frames of
    codes (uint8, checked by the caller), ``per_row`` to a batch row, rows
    ``pitch`` bytes apart: frame words into ``out`` (or None), the AM
    epilogue's scores and predictions when ``classes`` is given."""
    c = codes.shape[-1]
    k, w = item.shape[1], item.shape[2]
    if w * 32 != dim:
        raise ValueError(f"item {tuple(item.shape)} does not match dim={dim}")
    require(item, "item", torch.int32, (c, k, w))
    require(elec, "elec", torch.int32, (c, w))
    n_cls, scratch = 0, None
    if classes is not None:
        n_cls = classes.shape[0]
        require(classes, "class_hvs", torch.int32, (None, w))
        if n_cls < 1:
            raise ValueError("class_hvs: at least one class row")
        # partial sums and a ticket per frame, for frames whose word tiles
        # lie in several blocks (the launcher zeroes it when it is used)
        scratch = torch.empty(n_frames * (n_cls + 1), dtype=torch.int32,
                              device=codes.device)
    err = build.lib().dense_hdc_launch(
        codes.data_ptr(), item.data_ptr(), elec.data_ptr(),
        None if out is None else out.data_ptr(), n_frames, window, c, k, w,
        per_row, pitch, None if classes is None else classes.data_ptr(),
        None if scores is None else scores.data_ptr(),
        None if preds is None else preds.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n_cls,
        build.stream_ptr(codes))
    build.check(err, "dense_hdc")
    dense_encoder.launches += 1


def dense_encoder(codes: torch.Tensor, item: torch.Tensor,
                  elec: torch.Tensor, *, window: int,
                  dim: int) -> torch.Tensor:
    """codes (..., window, C) uint8 frame-viewed LBP codes, item (C, K, W)
    int32, elec (C, W) int32 -> (..., W) int32 packed frame HVs."""
    if use_plain(codes, item, elec):
        return plain("dense_hdc", dense_encoder_plain, codes, item, elec, window=window,
                     dim=dim)
    *lead, win, c = codes.shape
    if win != window:
        raise ValueError(f"codes {tuple(codes.shape)} do not match window={window}")
    require(codes, "codes", torch.uint8)
    out = torch.empty((*lead, item.shape[2]), dtype=torch.int32, device=codes.device)
    if out.numel():
        n = math.prod(lead)
        _launch(codes, n, n, n * window * c, item, elec, out, None, None, None,
                window=window, dim=dim)
    return out


dense_encoder.launches = 0


def _stream_launch(params: DenseIMParams, codes: torch.Tensor, cfg: HDCConfig,
                   class_hvs: torch.Tensor | None):
    """The kernel over a (B, T, C) stream read in place: frame HVs
    (B, F, W), or with class HVs (scores (B, F, n_classes), predictions
    (B, F))."""
    require(codes, "codes", torch.uint8, contiguous=False)
    per_row, pitch = stream_rows(codes, cfg.window)
    lead = (codes.shape[0], per_row)
    dev = codes.device
    if class_hvs is None:
        out = torch.empty((*lead, cfg.words), dtype=torch.int32, device=dev)
        res = out
        scores = preds = None
    else:
        out = None
        scores = torch.empty((*lead, class_hvs.shape[0]), dtype=torch.int32, device=dev)
        preds = torch.empty(lead, dtype=torch.int32, device=dev)
        res = scores, preds
    if lead[0] * per_row:
        _launch(codes, lead[0] * per_row, per_row, pitch, params.item_packed,
                params.elec_packed, out, class_hvs, scores, preds,
                window=cfg.window, dim=cfg.dim)
        if class_hvs is not None:
            encode_score_fused.launches += 1
    return res


def dense_encode_frames_fused(params: DenseIMParams, codes: torch.Tensor,
                              cfg: HDCConfig) -> torch.Tensor:
    """(B, T, C) uint8 codes -> (B, F, W) int32 frame HVs through the dense
    encoder kernel."""
    if use_plain(codes, params.item_packed, params.elec_packed):
        return plain("dense_hdc", dense_encoder_plain, frame_view(codes, cfg.window),
                     params.item_packed, params.elec_packed, window=cfg.window, dim=cfg.dim)
    return _stream_launch(params, codes, cfg, None)


def encode_score_fused(params: DenseIMParams, codes: torch.Tensor,
                       cfg: HDCConfig, class_hvs: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C) uint8 codes, (n_classes, W) int32 class HVs -> (D -
    Hamming scores (B, F, n_classes) int32, predictions (B, F) int32): the
    dense encoder kernel with its AM epilogue, one launch; the frame HVs
    are not written."""
    if use_plain(codes, params.item_packed, params.elec_packed, class_hvs):
        return plain("dense_hdc", encode_score_plain, frame_view(codes, cfg.window),
                     params.item_packed, params.elec_packed, class_hvs,
                     window=cfg.window, dim=cfg.dim)
    return _stream_launch(params, codes, cfg, class_hvs)


encode_score_fused.launches = 0
