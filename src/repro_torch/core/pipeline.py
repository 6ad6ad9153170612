"""One-shot HDC pipeline for the paper's datapath (port of
``repro.core.pipeline.HDCPipeline`` for ``variant="sparse_compim"``).

    cfg = HDCConfig()
    pipe = HDCPipeline.init(torch.Generator().manual_seed(42), cfg)
    pipe = pipe.calibrate_density(train_codes, target=0.25)
    pipe = pipe.train_one_shot(train_codes, train_labels)
    scores, preds = pipe.infer(test_codes)

The pipeline lives on one device (the card unless ``device="cpu"`` is
passed to ``init``).  Encoding runs the encoder kernel and scoring the AM
kernel on the card, their plain versions on the CPU; calibration runs the
plain datapath, as in the reference.  Methods are pure: training and
calibration return new pipelines.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import am, classifier, hv, online
from repro_torch.core import im as im_mod
from repro_torch.core.classifier import HDCConfig
from repro_torch.core.im import IMParams
from repro_torch.core.online import OnlineAMState
from repro_torch.device import resolve_device
from repro_torch.kernels.hdc_am.ops import am_search
from repro_torch.kernels.hdc_encoder.ops import encode_frames_fused

VARIANTS = ("sparse_compim",)

__all__ = ["HDCConfig", "HDCPipeline", "VARIANTS"]


def _check_cfg(cfg: HDCConfig) -> None:
    if cfg.variant not in VARIANTS:
        raise ValueError(f"variant {cfg.variant!r} is not ported; expected "
                         f"one of {VARIANTS}")


@dataclass(frozen=True)
class HDCPipeline:
    """IM params + (optional) trained class HVs and counter-file state."""
    params: IMParams
    cfg: HDCConfig
    class_hvs: torch.Tensor | None = None       # (n_classes, W) int32
    am_state: OnlineAMState | None = None

    @classmethod
    def init(cls, generator: torch.Generator, cfg: HDCConfig,
             device=None) -> "HDCPipeline":
        """Draw the codebooks from ``generator``; place them on ``device``
        (default: the CUDA card, raising when there is none)."""
        _check_cfg(cfg)
        params = im_mod.make_im(generator, channels=cfg.channels,
                                codes=cfg.codes, dim=cfg.dim,
                                segments=cfg.segments,
                                device=resolve_device(device))
        return cls(params=params, cfg=cfg)

    @property
    def device(self) -> torch.device:
        return self.params.item_pos.device

    def to(self, device) -> "HDCPipeline":
        return replace(
            self, params=self.params.to(device),
            class_hvs=None if self.class_hvs is None else self.class_hvs.to(device),
            am_state=None if self.am_state is None else self.am_state.to(device))

    # -- config rewrites ----------------------------------------------------

    _THRESHOLD_FIELDS = ("spatial_threshold", "temporal_threshold",
                         "class_density")

    def with_cfg(self, **overrides) -> "HDCPipeline":
        """Rebuild with new threshold fields; class HVs trained at the old
        operating point are dropped when any of them changes."""
        bad = sorted(set(overrides) - set(self._THRESHOLD_FIELDS))
        if bad:
            raise ValueError(f"with_cfg changes only {self._THRESHOLD_FIELDS}; "
                             f"got {bad}")
        new = replace(self.cfg, **overrides)
        chvs, state = self.class_hvs, self.am_state
        if new != self.cfg:
            chvs = state = None
        return replace(self, cfg=new, class_hvs=chvs, am_state=state)

    # -- encode / calibrate / train / infer ---------------------------------

    def _codes(self, codes) -> torch.Tensor:
        return torch.as_tensor(codes, dtype=torch.uint8, device=self.device)

    def encode_frames(self, codes) -> torch.Tensor:
        """(B, T, channels) uint8 codes -> (B, F, W) int32 frame HVs."""
        return encode_frames_fused(self.params, self._codes(codes), self.cfg)

    def frame_counts(self, codes) -> torch.Tensor:
        """Pre-threshold temporal accumulator counts (B, F, D)."""
        return classifier.frame_counts(self.params, self._codes(codes), self.cfg)

    def calibrate_density(self, codes, target: float) -> "HDCPipeline":
        """Program the temporal threshold so post-thinning frame density
        stays <= ``target`` on the calibration stream.  Calibrate before
        training: a changed threshold drops trained class HVs."""
        new_cfg = classifier.with_density_target(
            self.params, self._codes(codes), self.cfg, target)
        return self.with_cfg(temporal_threshold=new_cfg.temporal_threshold)

    def _check_labels(self, labels: torch.Tensor) -> None:
        """Reject training batches that would silently corrupt class HVs
        (labels out of range, or a class with no example)."""
        lab = labels.detach().cpu().numpy()
        if lab.size and (lab.min() < 0 or lab.max() >= self.cfg.n_classes):
            raise ValueError(
                f"labels must be in [0, {self.cfg.n_classes}), got range "
                f"[{lab.min()}, {lab.max()}]")
        missing = sorted(set(range(self.cfg.n_classes)) - set(np.unique(lab)))
        if missing:
            raise ValueError(
                f"classes {missing} have no examples in the training batch; "
                "their class HVs would be all-zero yet still score in the "
                "AM — provide at least one frame per class")

    def train_one_shot(self, codes, labels) -> "HDCPipeline":
        """codes (B, T, channels) uint8, labels (B, F) per-frame class ids
        -> a pipeline carrying class HVs and the counter-file state."""
        labels = torch.as_tensor(labels, device=self.device)
        self._check_labels(labels)
        frames = self.encode_frames(codes)                         # (B, F, W)
        bits = hv.unpack_bits(frames, self.cfg.dim).reshape(-1, self.cfg.dim)
        state = online.state_from_frames(bits, labels.reshape(-1),
                                         self.cfg.n_classes)
        chvs = online.class_hvs_from_state(state, self.cfg)
        return replace(self, class_hvs=chvs, am_state=state)

    def scores(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., W) frame HVs -> (..., n_classes) AM overlap scores."""
        if self.class_hvs is None:
            raise ValueError("pipeline has no class HVs; call train_one_shot first")
        return am_search(frames, self.class_hvs, mode="overlap", dim=self.cfg.dim)

    def infer(self, codes) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T, channels) codes -> (scores (B, F, n_classes),
        predictions (B, F))."""
        s = self.scores(self.encode_frames(codes))
        return s, am.am_predict(s)
