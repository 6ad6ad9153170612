"""HDC configuration and the plain sparse datapaths, naive and CompIM
(port of ``repro.core.classifier``).

``HDCConfig`` keeps the reference's fields and geometry validation except
``backend``: here the device of the tensors selects the path (CUDA kernels
on the card, plain PyTorch on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch.core import binding, bundling, im
from repro_torch.runtime.spans import span


@dataclass(frozen=True)
class HDCConfig:
    dim: int = 1024
    segments: int = 8
    channels: int = 64
    lbp_bits: int = 6
    window: int = 256           # temporal bundling length (one time frame)
    variant: str = "sparse_compim"
    spatial_thinning: bool = False   # paper-optimized: False (OR tree)
    spatial_threshold: int = 2       # used when spatial_thinning
    temporal_threshold: int = 130
    n_classes: int = 2
    class_density: float = 0.5       # training-time thinning target

    def __post_init__(self):
        """Geometry validation: every derived quantity (``words``,
        ``seg_len``, the uint8 position domain, the uint8 code alphabet)
        must be exact."""
        if self.dim <= 0 or self.dim % 32:
            raise ValueError(
                f"dim={self.dim} must be a positive multiple of 32 "
                "(HVs pack into 32-bit words)")
        if self.window <= 0:
            raise ValueError(f"window={self.window} must be positive")
        if not 1 <= self.lbp_bits <= 8:
            raise ValueError(
                f"lbp_bits={self.lbp_bits} must be in [1, 8] "
                "(LBP codes are uint8)")
        if self.n_classes < 1:
            raise ValueError(f"n_classes={self.n_classes} must be >= 1")
        if not 0.0 < self.class_density <= 1.0:
            raise ValueError(
                f"class_density={self.class_density} must be in (0, 1] "
                "(an out-of-range density silently thins class HVs to zero)")
        if self.variant == "dense":
            return  # the dense datapath has no segment structure
        if self.segments <= 0 or self.dim % self.segments:
            raise ValueError(
                f"dim={self.dim} must divide evenly into "
                f"segments={self.segments} (seg_len would truncate)")
        if self.dim // self.segments > 256:
            raise ValueError(
                f"seg_len={self.dim // self.segments} exceeds the uint8 "
                "position domain (max 256); increase segments for "
                f"dim={self.dim}")

    @property
    def codes(self) -> int:
        return 1 << self.lbp_bits

    @property
    def seg_len(self) -> int:
        return self.dim // self.segments

    @property
    def words(self) -> int:
        return self.dim // 32


def frame_view(codes: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, C) code stream -> (B, F, window, C), truncating the tail."""
    b, t, c = codes.shape
    frames = t // window
    return codes[:, : frames * window].reshape(b, frames, window, c)


def spatial_encode(params: im.IMParams, codes: torch.Tensor,
                   cfg: HDCConfig) -> torch.Tensor:
    """(..., channels) LBP codes -> (..., W) packed bundled HV."""
    if cfg.variant == "sparse_naive":
        data = im.im_lookup_packed(params, codes)                # (..., C, W)
        bound = binding.bind_segmented_packed(data, params.elec_packed,
                                              cfg.dim, cfg.segments)
        return bundling.spatial_bundle_thinned(bound, cfg.dim,
                                               cfg.spatial_threshold)
    if cfg.variant == "sparse_compim":
        pos = im.im_lookup_positions(params, codes)              # (..., C, S)
        bound = binding.bind_positions(pos, params.elec_pos, cfg.seg_len)
        if cfg.spatial_thinning:
            return bundling.spatial_bundle_thinned_positions(
                bound, cfg.dim, cfg.segments, cfg.spatial_threshold)
        return bundling.spatial_bundle_or_positions(bound, cfg.dim,
                                                    cfg.segments)
    if cfg.variant == "dense":
        raise ValueError("variant='dense' is routed by repro_torch.core."
                         "pipeline (this module holds the sparse datapaths)")
    raise ValueError(f"unknown sparse variant {cfg.variant!r}")


def encode_frames(params: im.IMParams, codes: torch.Tensor,
                  cfg: HDCConfig) -> torch.Tensor:
    """(B, T, channels) uint8 codes -> (B, T // window, W) frame HVs."""
    spatial = spatial_encode(params, frame_view(codes, cfg.window), cfg)
    return bundling.temporal_bundle(spatial, cfg.dim, cfg.temporal_threshold)


def frame_counts(params: im.IMParams, codes: torch.Tensor,
                 cfg: HDCConfig) -> torch.Tensor:
    """Temporal accumulator counts per frame (B, F, D) int32."""
    spatial = spatial_encode(params, frame_view(codes, cfg.window), cfg)
    return bundling.temporal_counts(spatial, cfg.dim)


def with_density_target(params: im.IMParams, codes: torch.Tensor,
                        cfg: HDCConfig, target: float) -> HDCConfig:
    """cfg with temporal_threshold calibrated so the post-thinning density
    stays <= ``target`` on the given calibration stream.  The threshold is
    read back to the host: a config field is a Python int."""
    with span("calibrate.counts"):
        counts = frame_counts(params, codes, cfg)
    with span("calibrate.threshold"):
        thr = int(bundling.threshold_for_density(counts, target))
    return replace(cfg, temporal_threshold=thr)
