"""Fused sparse-HDC encoder: CUDA kernel for CUDA tensors, plain version
for CPU tensors (port of ``repro.kernels.hdc_encoder.ops``).

The TPU kernel takes the item positions already gathered; the CUDA kernel
takes the frame-viewed codes and the CompIM table and gathers itself, so
the (..., window, C, S) position tensor is never materialised on the card.
The pipeline's entry points hand it the (B, T, C) code stream where it lies
(``codes[1:]`` cut to whole frames is not copied), and with the class HVs
it scores the frames itself (its AM epilogue): ``encode_score_fused`` is
the offline pipeline's whole inference in one launch.  Its counts epilogue
writes the temporal counts before the threshold instead
(``frame_counts_fused``): calibration's counts in one launch.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from repro_torch.core.classifier import HDCConfig, frame_counts, frame_view
from repro_torch.core.im import IMParams
from repro_torch.kernels import build
from repro_torch.kernels.common import all_fake, plain, require, stream_rows, use_plain
from repro_torch.kernels.hdc_encoder.ref import encode_score_plain, encoder_plain
from repro_torch.runtime import op_cost


def work(n_frames: int, window: int, channels: int, codes_k: int, segments: int,
         seg_len: int, n_classes: int = 0, counts: bool = False) -> tuple[int, int]:
    """(bytes, integer operations) of one launch over ``n_frames`` frames:
    the bound of the encoder's row in PERF.md's kernel table.  Bytes: the
    codes, the CompIM table (C, K, S) and the electrode positions once, and
    the frame HVs written, or with ``n_classes`` class rows the rows read
    and the scores and predictions written, or with ``counts`` (the counts
    epilogue) the (n_frames, D) int32 counts written.  Operations: a bind
    per (frame, cycle, channel, segment), a word operation per (frame,
    cycle, word), and two per (frame, class, word) in the AM epilogue (AND,
    popcount)."""
    words = segments * seg_len // 32
    n_bytes = (n_frames * window * channels + channels * codes_k * segments
               + channels * segments)
    n_ops = n_frames * window * channels * segments + n_frames * window * words
    if n_classes:
        n_bytes += n_classes * words * 4 + n_frames * (n_classes + 1) * 4
        n_ops += n_frames * n_classes * words * 2
    elif counts:
        n_bytes += n_frames * words * 32 * 4
    else:
        n_bytes += n_frames * words * 4
    return n_bytes, n_ops


def _launch(codes, n_frames, per_row, pitch, item_pos, elec, out, classes,
            scores, preds, *, window, segments, seg_len, temporal_threshold,
            spatial_thinning, spatial_threshold, counts=None) -> bool:
    """Check the tables and classes and launch over ``n_frames`` frames of
    codes (uint8, checked by the caller), ``per_row`` to a batch row, rows
    ``pitch`` bytes apart: frame words into ``out`` (or None), the AM
    epilogue's scores and predictions when ``classes`` is given, or the
    counts epilogue's (n_frames, D) counts into ``counts``.  True when it
    launched.  On fake tensors (the dry-run) the outputs are already
    made: the launch and its ``work`` are recorded in ``op_cost``, nothing
    runs, the wrappers' ``launches`` counts stay as they were, and False is
    returned."""
    c = codes.shape[-1]
    require(item_pos, "item_pos", torch.uint8, (c, None, segments))
    require(elec, "elec", torch.uint8, (c, segments))
    dim = segments * seg_len
    if dim % 32 or not 1 <= seg_len <= 256:
        raise ValueError(f"D={dim} must be a multiple of 32 and seg_len="
                         f"{seg_len} in [1, 256]")
    n_cls = 0
    if classes is not None:
        n_cls = classes.shape[0]
        require(classes, "class_hvs", torch.int32, (None, dim // 32))
        if n_cls < 1:
            raise ValueError("class_hvs: at least one class row")
    operands = (codes, item_pos, elec) + (() if classes is None else (classes,))
    if all_fake(*operands):
        op_cost.record_kernel("hdc_encoder", *work(
            n_frames, window, c, item_pos.shape[1], segments, seg_len, n_cls,
            counts is not None))
        return False
    err = build.lib().hdc_encoder_launch(
        codes.data_ptr(), item_pos.data_ptr(), elec.data_ptr(),
        None if out is None else out.data_ptr(), n_frames, window, c,
        item_pos.shape[1], segments, seg_len, int(temporal_threshold),
        int(bool(spatial_thinning)), int(spatial_threshold), per_row, pitch,
        None if classes is None else classes.data_ptr(),
        None if scores is None else scores.data_ptr(),
        None if preds is None else preds.data_ptr(), n_cls,
        None if counts is None else counts.data_ptr(), build.stream_ptr(codes))
    build.check(err, "hdc_encoder")
    encoder.launches += 1
    return True


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
        return plain("hdc_encoder", encoder_plain, codes, item_pos, elec, **kw)
    *lead, win, c = codes.shape
    if win != window:
        raise ValueError(f"codes {tuple(codes.shape)} do not match "
                         f"window={window}")
    require(codes, "codes", torch.uint8)
    out = torch.empty((*lead, segments * seg_len // 32), dtype=torch.int32,
                      device=codes.device)
    if out.numel():
        n = math.prod(lead)
        _launch(codes, n, n, n * window * c, item_pos, elec, out, None, None,
                None, **kw)
    return out


encoder.launches = 0


def _cfg_kw(cfg: HDCConfig) -> dict:
    return dict(window=cfg.window, segments=cfg.segments, seg_len=cfg.seg_len,
                temporal_threshold=cfg.temporal_threshold,
                spatial_thinning=cfg.spatial_thinning,
                spatial_threshold=cfg.spatial_threshold)


def _stream_launch(params: IMParams, codes: torch.Tensor, cfg: HDCConfig,
                   class_hvs: torch.Tensor | None, counts: bool = False):
    """The kernel over a (B, T, C) stream read in place: frame HVs
    (B, F, W), or with class HVs (scores (B, F, n_classes), predictions
    (B, F)), or with ``counts`` the temporal counts (B, F, D)."""
    require(codes, "codes", torch.uint8, contiguous=False)
    per_row, pitch = stream_rows(codes, cfg.window)
    lead = (codes.shape[0], per_row)
    dev = codes.device
    out = scores = preds = cnt = None
    if counts:
        res = cnt = torch.empty((*lead, cfg.dim), dtype=torch.int32, device=dev)
    elif class_hvs is None:
        res = out = torch.empty((*lead, cfg.words), dtype=torch.int32, device=dev)
    else:
        scores = torch.empty((*lead, class_hvs.shape[0]), dtype=torch.int32, device=dev)
        preds = torch.empty(lead, dtype=torch.int32, device=dev)
        res = scores, preds
    if lead[0] * per_row:
        launched = _launch(codes, lead[0] * per_row, per_row, pitch, params.item_pos,
                           params.elec_pos, out, class_hvs, scores, preds, **_cfg_kw(cfg),
                           counts=cnt)
        if launched and class_hvs is not None:
            encode_score_fused.launches += 1
        if launched and counts:
            frame_counts_fused.launches += 1
    return res


def encode_frames_fused(params: IMParams, codes: torch.Tensor,
                        cfg: HDCConfig) -> torch.Tensor:
    """(B, T, C) uint8 codes -> (B, F, W) int32 frame HVs through the
    encoder kernel, which gathers the CompIM positions itself."""
    if use_plain(codes, params.item_pos, params.elec_pos):
        return plain("hdc_encoder", encoder_plain, frame_view(codes, cfg.window),
                     params.item_pos, params.elec_pos, **_cfg_kw(cfg))
    return _stream_launch(params, codes, cfg, None)


def encode_score_fused(params: IMParams, codes: torch.Tensor, cfg: HDCConfig,
                       class_hvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C) uint8 codes, (n_classes, W) int32 class HVs -> (overlap
    scores (B, F, n_classes) int32, predictions (B, F) int32): the encoder
    kernel with its AM epilogue, one launch; the frame HVs are not
    written."""
    if use_plain(codes, params.item_pos, params.elec_pos, class_hvs):
        return plain("hdc_encoder", encode_score_plain, frame_view(codes, cfg.window),
                     params.item_pos, params.elec_pos, class_hvs, **_cfg_kw(cfg))
    return _stream_launch(params, codes, cfg, class_hvs)


encode_score_fused.launches = 0


def frame_counts_fused(params: IMParams, codes: torch.Tensor,
                       cfg: HDCConfig) -> torch.Tensor:
    """(B, T, C) uint8 codes -> (B, F, D) int32 temporal counts before the
    threshold (calibration's counts): the encoder kernel with its counts
    epilogue, one launch; no frame HVs are written.  Its plain version is
    the position-domain ``classifier.frame_counts``."""
    if use_plain(codes, params.item_pos, params.elec_pos):
        return plain("hdc_encoder", frame_counts, params, codes,
                     replace(cfg, variant="sparse_compim"))
    return _stream_launch(params, codes, cfg, None, counts=True)


frame_counts_fused.launches = 0
