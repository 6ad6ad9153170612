"""Bundling with and without thinning (port of ``repro.core.bundling``):
the packed-domain (naive) and position-domain (CompIM) spatial bundles,
temporal bundling and the density calibration rule."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hv


def spatial_counts_packed(bound: torch.Tensor, dim: int) -> torch.Tensor:
    """Adder tree: (..., N, W) packed -> (..., D) int32 per-bit counts."""
    return hv.unpacked_counts(bound, axis=-2, dim=dim)


def spatial_bundle_thinned(bound: torch.Tensor, dim: int,
                           threshold: int) -> torch.Tensor:
    """Naive spatial bundling: adder tree + thinning threshold -> packed."""
    return hv.threshold_pack(spatial_counts_packed(bound, dim), threshold)


def spatial_bundle_or(bound: torch.Tensor) -> torch.Tensor:
    """OR tree over the channels: (..., N, W) -> (..., W)."""
    return hv.or_reduce(bound, axis=-2)


def spatial_bundle_or_positions(pos: torch.Tensor, dim: int,
                                segments: int) -> torch.Tensor:
    """(..., N, S) positions -> packed (..., W): OR over the N channels."""
    return hv.or_reduce(hv.positions_to_packed(pos, dim, segments), axis=-2)


def spatial_counts_positions(pos: torch.Tensor, dim: int,
                             segments: int) -> torch.Tensor:
    """(..., N, S) positions -> (..., D) int32 per-bit channel counts."""
    packed = hv.positions_to_packed(pos, dim, segments)    # (..., N, W)
    return hv.unpacked_counts(packed, axis=-2, dim=dim)


def spatial_bundle_thinned_positions(pos: torch.Tensor, dim: int,
                                     segments: int,
                                     threshold: int) -> torch.Tensor:
    return hv.threshold_pack(spatial_counts_positions(pos, dim, segments),
                             threshold)


def temporal_counts(frames: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., T, W) packed -> (..., D) int32 counter-bank accumulation."""
    return hv.unpacked_counts(frames, axis=-2, dim=dim)


def temporal_bundle(frames: torch.Tensor, dim: int, threshold) -> torch.Tensor:
    """Temporal bundling with thinning -> packed time-frame HV."""
    return hv.threshold_pack(temporal_counts(frames, dim), threshold)


def threshold_for_density(counts: torch.Tensor,
                          target_density: float) -> torch.Tensor:
    """Smallest integer thinning threshold with density <= target.

    The reference's rule in the reference's float32 arithmetic: the
    linear-interpolated ``1 - target`` quantile of each (..., D) row,
    averaged over the leading axes, ``ceil(mean) + 1``, floored at 1.  The
    reference's compiler turns the mean's division by the constant row
    count into a product with its float32 reciprocal, which can land just
    above an integer (570 * (1 / 95) = 6.0000005) and so move the ceiling;
    the mean here is taken the same way.  The sum is rounded once from
    float64: the quantiles are multiples of small powers of two, so it is
    exact in float32 in any order.

    Reads the device from the host twice: the quantile's two indices
    (``.item()`` each), which select the sorted rows' columns.  The result
    stays on the device.
    """
    a = torch.sort(counts.to(torch.float32), dim=-1).values
    n = a.shape[-1]
    q = torch.tensor(1.0 - target_density, dtype=torch.float32,
                     device=a.device) * float(n - 1)
    low = torch.floor(q)
    high = torch.ceil(q)
    high_weight = q - low
    low_weight = 1.0 - high_weight
    lv = a[..., int(low.clamp(0, n - 1).item())]
    hv_ = a[..., int(high.clamp(0, n - 1).item())]
    quant = lv * low_weight + hv_ * high_weight
    total = quant.to(torch.float64).sum().to(torch.float32)
    inv = torch.tensor(np.float32(1) / np.float32(max(quant.numel(), 1)),
                       device=a.device)
    thr = torch.ceil(total * inv) + 1.0
    return torch.clamp(thr, min=1.0).to(torch.int32)
