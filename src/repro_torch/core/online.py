"""Online continual learning for the AM (port of ``repro.core.online``).

``OnlineAMState`` is the counter-file view of the AM: per-class integer
accumulators ``counts`` (C, D) and the frames bundled per class ``n``.
The gated update adds a frame's bits to its true class and subtracts them
from the rival (the best-scoring wrong class) when the prediction is wrong
or its lead is below ``margin``; the class HVs are then re-thresholded from
the counts (sparse: thinned to ``class_density``; dense: majority).

Everything is plain torch and broadcasts over leading dims (the fleet
stacks S states into an (S, C, D) bank).  No function reads the device
from the host, so ``fit_iterative``'s epochs queue on the stream; integer
products are written as per-class masked sums, since CUDA has no int32
matrix product."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import hv
from repro_torch.core.classifier import HDCConfig


@dataclass(frozen=True)
class OnlineAMState:
    """Per-class accumulated frame bits; leading dims stack sessions."""

    counts: torch.Tensor  # (..., C, D) int32
    n: torch.Tensor       # (..., C) int32 frames bundled per class

    def to(self, device) -> "OnlineAMState":
        return OnlineAMState(self.counts.to(device), self.n.to(device))


def state_from_frames(frame_bits: torch.Tensor, labels: torch.Tensor,
                      n_classes: int) -> OnlineAMState:
    """One-shot accumulation: (N, D) {0,1} bits + (N,) labels -> state."""
    bits = frame_bits.to(torch.int32)
    onehot = _one_hot(labels.to(bits.device), n_classes)       # (N, C)
    return OnlineAMState(counts=_class_sums(onehot, bits),
                         n=onehot.sum(0, dtype=torch.int32))


def _one_hot(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(...,) class ids -> (..., C) int32 one-hot (an id outside [0, C)
    gives a zero row)."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels.unsqueeze(-1) == classes).to(torch.int32)


def _class_sums(weights: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``einsum("nc,nd->cd")`` of (N, C) int32 weights and (N, D) int32
    bits, as one masked integer sum per class (no int32 matmul on CUDA)."""
    return torch.stack([(weights[:, c, None] * bits).sum(0, dtype=torch.int32)
                        for c in range(weights.shape[1])])


def _density_threshold(counts: torch.Tensor, density) -> torch.Tensor:
    """Smallest thinning threshold with density <= ``density`` per row,
    in the reference's float32 arithmetic (linear-interpolated quantile)."""
    d = counts.shape[-1]
    srt = torch.sort(counts.to(torch.float32), dim=-1).values
    if not isinstance(density, torch.Tensor):  # a fill, not a host copy
        density = torch.full((), density, dtype=torch.float32,
                             device=counts.device)
    pos = ((1.0 - density) * float(d - 1)).expand(counts.shape[:-1])
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    vlo = torch.gather(srt, -1, lo.unsqueeze(-1)).squeeze(-1)
    vhi = torch.gather(srt, -1, hi.unsqueeze(-1)).squeeze(-1)
    q = vlo + (pos - lo.to(torch.float32)) * (vhi - vlo)
    return torch.clamp(torch.ceil(q) + 1.0, min=1.0).to(torch.int32)


def class_hvs_from_state(state: OnlineAMState, cfg: HDCConfig,
                         density=None) -> torch.Tensor:
    """Re-threshold the counter file: (..., C, D) -> (..., C, W) class HVs.
    Sparse: each row thinned to ``density`` (default ``cfg.class_density``);
    dense: per-bit majority over the ``n`` frames bundled per class."""
    counts = torch.clamp(state.counts, min=0)
    if cfg.variant == "dense":
        n = torch.clamp(state.n, min=1).unsqueeze(-1)
        return hv.majority_pack(counts, n, cfg.dim)
    if density is None:
        density = cfg.class_density
    thr = _density_threshold(counts, density)
    return hv.threshold_pack(counts, thr.unsqueeze(-1))


def _gated_delta(labels: torch.Tensor, scores: torch.Tensor, margin,
                 valid: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared gating rule: (..., C) int32 class deltas + (...) bool gate.

    The gate fires when the prediction is wrong or the true-vs-rival score
    margin (float32) is below ``margin``; the rival is the best-scoring
    class other than the true one (argmax ties to the lower class, as
    ``am.am_predict``).  ``labels < 0`` (no feedback) and ``valid == False``
    (no frame) turn the update off."""
    c = scores.shape[-1]
    lab = torch.clamp(labels.to(torch.int64), min=0)
    pred = torch.argmax(scores, dim=-1)
    one_true = _one_hot(lab, c)
    s = scores.to(torch.float32)
    s_true = torch.gather(s, -1, lab.unsqueeze(-1)).squeeze(-1)
    masked = torch.where(one_true == 1, float("-inf"), s)
    rival = torch.argmax(masked, dim=-1)
    s_rival = masked.max(dim=-1).values
    # a tensor margin (a captured adapt's static operand) holds the float32
    # value the host rounds a Python margin to
    thr = margin if isinstance(margin, torch.Tensor) else float(np.float32(margin))
    gate = (pred != lab) | (s_true - s_rival < thr)
    gate = gate & (labels >= 0)
    if valid is not None:
        gate = gate & valid
    delta = torch.where(gate.unsqueeze(-1), one_true - _one_hot(rival, c), 0)
    return delta, gate


def update(state: OnlineAMState, frame_bits: torch.Tensor,
           labels: torch.Tensor, scores: torch.Tensor, *, margin=0.0,
           valid: torch.Tensor | None = None
           ) -> tuple[OnlineAMState, torch.Tensor]:
    """Confidence-gated update, one frame per state: frame_bits (..., D)
    {0,1}, labels (...,), scores (..., C); the leading dims agree with the
    state's.  Counts and n clamp at zero.  Returns ``(state, applied)``."""
    delta, gate = _gated_delta(labels, scores, margin, valid)
    bits = frame_bits.to(torch.int32).unsqueeze(-2)             # (..., 1, D)
    counts = state.counts + delta.unsqueeze(-1) * bits
    return OnlineAMState(counts=torch.clamp(counts, min=0),
                         n=torch.clamp(state.n + delta, min=0)), gate


def batch_update(state: OnlineAMState, frame_bits: torch.Tensor,
                 labels: torch.Tensor, scores: torch.Tensor, *,
                 margin=0.0) -> tuple[OnlineAMState, torch.Tensor]:
    """One epoch of batch-iterative retraining against one shared state:
    frame_bits (N, D), labels (N,), scores (N, C); all N gated frames apply
    at once.  Returns ``(state, gate)`` with gate (N,) bool."""
    delta, gate = _gated_delta(labels, scores, margin, None)   # (N, C)
    counts = state.counts + _class_sums(delta, frame_bits.to(torch.int32))
    n = state.n + delta.sum(0, dtype=torch.int32)
    return OnlineAMState(counts=torch.clamp(counts, min=0),
                         n=torch.clamp(n, min=0)), gate
