"""Counter-file view of the AM (port of ``repro.core.online``: the state,
one-shot accumulation and re-thresholding, sparse and dense; the gated
update rules are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

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
    lab = labels.to(bits.device)
    counts = torch.stack([bits[lab == c].sum(0, dtype=torch.int32)
                          for c in range(n_classes)])
    n = torch.stack([(lab == c).sum(dtype=torch.int32)
                     for c in range(n_classes)])
    return OnlineAMState(counts=counts, n=n)


def _density_threshold(counts: torch.Tensor, density) -> torch.Tensor:
    """Smallest thinning threshold with density <= ``density`` per row,
    in the reference's float32 arithmetic (linear-interpolated quantile)."""
    d = counts.shape[-1]
    srt = torch.sort(counts.to(torch.float32), dim=-1).values
    density = torch.as_tensor(density, dtype=torch.float32,
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
