"""The plain reference of the detector's datapath, for both configurations.

Plain torch on any device, written from the system's description and not
from the port: it imports nothing of the program.  It takes the inputs the
benchmark made (signal, labels, codebooks) and works out again everything
the program derives from them: LBP codes, frame counts and frame HVs, the
calibrated threshold, the class HVs and the counter file, the AM scores and
the predictions.  Frames are taken in blocks so that an hour of signal fits
beside whatever else is on the card.

Bit ``d`` of a hypervector is bit ``d % 32`` of 32-bit word ``d // 32``;
words are carried as int32 with the same bit pattern.

``signal_dtype`` lowers the precision of the signal the LBP compares (the
control: bfloat16 below the configuration's float32).
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 32


# ---------------------------------------------------------------------------
# bits and words
# ---------------------------------------------------------------------------

def pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., D) bool -> (..., D // 32) int32 words, LSB first."""
    d = bits.shape[-1]
    b = bits.reshape(*bits.shape[:-1], d // WORD, WORD).to(torch.int64)
    v = (b << torch.arange(WORD, device=bits.device)).sum(-1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def unpack(words: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., dim) bool: each word's four bytes
    (little-endian, so byte j holds bits 8j..8j+7) looked up in a table of
    their eight bits, LSB first."""
    table = ((torch.arange(256, device=words.device).unsqueeze(1)
              >> torch.arange(8, device=words.device)) & 1).to(torch.bool)
    b = words.contiguous().view(torch.uint8).to(torch.int64)            # (..., 4W)
    return table[b].reshape(*words.shape[:-1], -1)[..., :dim]


# ---------------------------------------------------------------------------
# LBP and frame encodings
# ---------------------------------------------------------------------------

def lbp(x: torch.Tensor, bits: int, signal_dtype=torch.float32) -> torch.Tensor:
    """(T, C) signal -> (T - bits, C) uint8: bit i of code t is
    [x[t + bits - i] > x[t + bits - i - 1]], compared in ``signal_dtype``."""
    x = x.to(signal_dtype)
    up = (x[1:] > x[:-1]).to(torch.int32)
    t_out = x.shape[0] - bits
    code = torch.zeros((t_out, x.shape[1]), dtype=torch.int32, device=x.device)
    for i in range(bits):
        code += up[bits - 1 - i: bits - 1 - i + t_out] << i
    return code.to(torch.uint8)


def sparse_counts(codes: torch.Tensor, item_pos: torch.Tensor, elec_pos: torch.Tensor,
                  hdc: dict, block: int = 128) -> torch.Tensor:
    """CompIM datapath up to the temporal counter bank: (T', C) codes ->
    (F, D) int32 counts of the cycles in each frame whose spatial HV has
    bit d.  Per cycle and channel each segment's bit sits at (item position
    + electrode position) mod the segment length; the spatial HV is the OR
    over the channels (or, with spatial thinning, the bits that at least
    ``spatial_threshold`` channels set)."""
    win, c, s = hdc["window"], hdc["channels"], hdc["segments"]
    dim = hdc["dim"]
    seg_len = dim // s
    k = item_pos.shape[1]
    f_all = codes.shape[0] // win
    ch = torch.arange(c, device=codes.device)
    seg0 = torch.arange(s, device=codes.device) * seg_len
    elec = elec_pos.to(torch.int64)
    out = torch.empty((f_all, dim), dtype=torch.int32, device=codes.device)
    for f0 in range(0, f_all, block):
        f1 = min(f_all, f0 + block)
        cb = codes[f0 * win: f1 * win].to(torch.int64).clamp(max=k - 1)   # (n, C)
        pos = item_pos[ch, cb].to(torch.int64)                             # (n, C, S)
        idx = (pos + elec) % seg_len + seg0                                # (n, C, S)
        n = idx.shape[0]
        per_bit = torch.zeros((n, dim), dtype=torch.int32, device=codes.device)
        per_bit.scatter_add_(1, idx.reshape(n, c * s),
                             torch.ones((n, c * s), dtype=torch.int32, device=codes.device))
        if hdc["spatial_thinning"]:
            spatial = per_bit >= hdc["spatial_threshold"]
        else:
            spatial = per_bit > 0
        out[f0:f1] = spatial.reshape(f1 - f0, win, dim).sum(1, dtype=torch.int32)
    return out


def dense_bits(codes: torch.Tensor, item: torch.Tensor, elec: torch.Tensor,
               hdc: dict, block: int = 16) -> torch.Tensor:
    """Dense datapath: (T', C) codes -> (F, D) frame bits.  Per cycle each
    channel's item HV XOR its electrode HV; a bit of the spatial HV is set
    when more than half of the channels set it; a bit of the frame HV when
    more than half of the window's cycles set it."""
    win, c, dim = hdc["window"], hdc["channels"], hdc["dim"]
    k = item.shape[1]
    f_all = codes.shape[0] // win
    ch = torch.arange(c, device=codes.device)
    out = torch.empty((f_all, dim), dtype=torch.bool, device=codes.device)
    for f0 in range(0, f_all, block):
        f1 = min(f_all, f0 + block)
        cb = codes[f0 * win: f1 * win].to(torch.int64).clamp(max=k - 1)
        words = item[ch, cb] ^ elec                                        # (n, C, W)
        per_bit = unpack(words, dim).sum(1, dtype=torch.int32)             # (n, D)
        spatial = per_bit * 2 > c
        t_counts = spatial.reshape(f1 - f0, win, dim).sum(1, dtype=torch.int32)
        out[f0:f1] = t_counts * 2 > win
    return out


# ---------------------------------------------------------------------------
# thresholds, AM, training
# ---------------------------------------------------------------------------

def calib_threshold(counts: torch.Tensor, target: float) -> int:
    """The temporal threshold for a maximum frame density ``target``: the
    linearly interpolated ``1 - target`` quantile of each frame's counts,
    averaged over the frames, rounded up, plus one, at least 1; in float32
    arithmetic, the mean taken as the sum times the float32 reciprocal of
    the frame count."""
    f, d = counts.shape
    srt = torch.sort(counts.to(torch.float32), dim=-1).values
    q = np.float32(np.float32(1.0 - target) * np.float32(d - 1))
    lo, hi = int(np.floor(q)), int(np.ceil(q))
    w_hi = np.float32(q - np.float32(lo))
    w_lo = np.float32(np.float32(1.0) - w_hi)
    vlo = srt[:, lo].cpu().numpy()
    vhi = srt[:, hi].cpu().numpy()
    quant = (vlo * w_lo).astype(np.float32) + (vhi * w_hi).astype(np.float32)
    total = np.float32(quant.astype(np.float64).sum())
    inv = np.float32(np.float32(1.0) / np.float32(max(f, 1)))
    thr = np.ceil(np.float32(total * inv)) + np.float32(1.0)
    return int(max(thr, 1.0))


def am_scores(frame_bits: torch.Tensor, class_bits: torch.Tensor, hdc: dict) -> torch.Tensor:
    """(F, D) x (K, D) bits -> (F, K) int32: overlap (AND popcount) for the
    sparse variants, D minus the Hamming distance for dense."""
    a = frame_bits.unsqueeze(1)
    b = class_bits.unsqueeze(0)
    if hdc["variant"] == "dense":
        return hdc["dim"] - (a ^ b).sum(-1, dtype=torch.int32)
    return (a & b).sum(-1, dtype=torch.int32)


def predict(scores: torch.Tensor) -> torch.Tensor:
    """(F, K) -> (F,) int32: the best class, ties to the lower class."""
    pred = torch.zeros(scores.shape[0], dtype=torch.int32, device=scores.device)
    best = scores[:, 0]
    for k in range(1, scores.shape[1]):
        better = scores[:, k] > best
        pred = torch.where(better, k, pred)
        best = torch.where(better, scores[:, k], best)
    return pred


def class_bits(counts: torch.Tensor, n: torch.Tensor, hdc: dict) -> torch.Tensor:
    """Counter file (K, D) -> class HV bits (K, D).  Sparse: each row thinned
    to ``class_density`` by the linearly interpolated quantile rule (float32),
    threshold ceil(q) + 1, at least 1.  Dense: more than half of the class's
    frames."""
    counts = counts.clamp(min=0)
    if hdc["variant"] == "dense":
        return counts * 2 > n.clamp(min=1).unsqueeze(-1)
    d = counts.shape[-1]
    srt = torch.sort(counts.to(torch.float32), dim=-1).values
    pos = np.float32(np.float32(1.0 - hdc["class_density"]) * np.float32(d - 1))
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    frac = np.float32(pos - np.float32(lo))
    q = srt[:, lo] + frac * (srt[:, hi] - srt[:, lo])
    thr = torch.clamp(torch.ceil(q) + 1.0, min=1.0)
    return counts >= thr.unsqueeze(-1)


def one_shot(frame_bits: torch.Tensor, labels: torch.Tensor, n_classes: int):
    """(F, D) bits, (F,) labels -> counter file (K, D) int32, frames (K,)."""
    bits = frame_bits.to(torch.int32)
    counts = torch.stack([bits[labels == k].sum(0, dtype=torch.int32)
                          for k in range(n_classes)])
    n = torch.stack([(labels == k).sum(dtype=torch.int32) for k in range(n_classes)])
    return counts, n


def fit(frame_bits: torch.Tensor, labels: torch.Tensor, hdc: dict, epochs: int):
    """One-shot counter file, then ``epochs`` batch passes: every frame
    scored against the thresholded class HVs; a frame whose prediction is
    wrong adds its bits to its true class and subtracts them from the best
    other class; counts and frame numbers clamp at zero.  Returns (class
    bits, counts, n)."""
    k = hdc["n_classes"]
    counts, n = one_shot(frame_bits, labels, k)
    bits = frame_bits.to(torch.int32)
    lab = labels.to(torch.int64)
    ks = torch.arange(k, device=labels.device)
    for _ in range(epochs):
        scores = am_scores(frame_bits, class_bits(counts, n, hdc), hdc)
        pred = predict(scores).to(torch.int64)
        others = torch.where(ks == lab.unsqueeze(1), float("-inf"), scores.to(torch.float32))
        rival = predict(others).to(torch.int64)
        gate = pred != lab
        delta = ((ks == lab.unsqueeze(1)).to(torch.int32)
                 - (ks == rival.unsqueeze(1)).to(torch.int32)) * gate.unsqueeze(1)
        for c in range(k):
            counts[c] += (delta[:, c:c + 1] * bits).sum(0, dtype=torch.int32)
        n = n + delta.sum(0, dtype=torch.int32)
        counts, n = counts.clamp(min=0), n.clamp(min=0)
    return class_bits(counts, n, hdc), counts, n


# ---------------------------------------------------------------------------
# what a request or a job produces
# ---------------------------------------------------------------------------

def frame_bits(codes: torch.Tensor, book: dict, hdc: dict, threshold: int) -> torch.Tensor:
    """(T', C) codes -> (F, D) frame bits at a temporal threshold (sparse) or
    by the dense majorities."""
    if hdc["variant"] == "dense":
        return dense_bits(codes, book["item"], book["elec"], hdc)
    return sparse_counts(codes, book["item"], book["elec"], hdc) >= threshold


def bank(x: torch.Tensor, labels: torch.Tensor, book: dict, cfg: dict,
         signal_dtype=torch.float32) -> dict:
    """A patient's bank from one labelled training recording: calibrated
    (where the configuration calibrates) and trained one-shot."""
    hdc = cfg["hdc"]
    codes = lbp(x, hdc["lbp_bits"], signal_dtype)
    thr = hdc["temporal_threshold"]
    if hdc["variant"] != "dense" and cfg["calibrate_target"] is not None:
        thr = calib_threshold(sparse_counts(codes, book["item"], book["elec"], hdc),
                              cfg["calibrate_target"])
    bits = frame_bits(codes, book, hdc, thr)
    counts, n = one_shot(bits, labels, hdc["n_classes"])
    return {"threshold": thr, "class_bits": class_bits(counts, n, hdc)}


def review(x: torch.Tensor, book: dict, patient_bank: dict, cfg: dict,
           signal_dtype=torch.float32) -> dict:
    """One review request: codes, scores (F, K) and predictions (F,)."""
    hdc = cfg["hdc"]
    codes = lbp(x, hdc["lbp_bits"], signal_dtype)
    bits = frame_bits(codes, book, hdc, patient_bank["threshold"])
    scores = am_scores(bits, patient_bank["class_bits"], hdc)
    return {"codes": codes, "scores": scores, "preds": predict(scores)}


def onboard(x: torch.Tensor, labels: torch.Tensor, book: dict, cfg: dict, epochs: int,
            signal_dtype=torch.float32) -> dict:
    """One onboarding job: the calibrated threshold, the class HVs (words)
    and the counter file after ``epochs`` of iterative retraining."""
    hdc = cfg["hdc"]
    codes = lbp(x, hdc["lbp_bits"], signal_dtype)
    thr = hdc["temporal_threshold"]
    if hdc["variant"] != "dense":
        counts = sparse_counts(codes, book["item"], book["elec"], hdc)
        if cfg["calibrate_target"] is not None:
            thr = calib_threshold(counts, cfg["calibrate_target"])
        bits = counts >= thr
    else:
        bits = dense_bits(codes, book["item"], book["elec"], hdc)
    cbits, counts, n = fit(bits, labels, hdc, epochs)
    return {"threshold": thr, "class_hvs": pack(cbits), "counts": counts, "n": n}
