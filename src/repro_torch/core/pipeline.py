"""One-shot HDC pipeline for the paper's three datapaths (port of
``repro.core.pipeline.HDCPipeline``):

* ``sparse_compim`` — CompIM position-domain binding, OR-tree (or, with
  ``spatial_thinning``, adder-tree) spatial bundle; the paper's design;
* ``sparse_naive``  — packed IM, one-hot decoder + barrel-shift binding,
  adder-tree spatial bundle with thinning;
* ``dense``         — the dense-HDC comparison system: XOR binding,
  channel and temporal majorities, Hamming AM.

    cfg = HDCConfig()                        # or HDCConfig(variant="dense")
    pipe = HDCPipeline.init(torch.Generator().manual_seed(42), cfg)
    pipe = pipe.calibrate_density(train_codes, target=0.25)
    pipe = pipe.train_one_shot(train_codes, train_labels)
    pipe = pipe.fit_iterative(train_codes, train_labels, epochs=5)  # optional
    scores, preds = pipe.infer(test_codes)

The pipeline lives on one device (the card unless ``device="cpu"`` is
passed to ``init``).  Encoding runs the encoder kernels and scoring the AM
kernel on the card, their plain versions on the CPU; ``infer`` on the card
is one launch, the encoder kernel with its AM epilogue, while ``scores``
keeps the standalone AM kernel, which ``fit_iterative`` runs once an epoch.
Calibration's counts on the card are one launch too, the encoder kernel
with its counts epilogue; on the CPU the plain datapath, as in the
reference.  Methods are pure: training and calibration return new
pipelines.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import am, binding, bundling, classifier, hv, online
from repro_torch.core import im as im_mod
from repro_torch.core.classifier import HDCConfig
from repro_torch.core.im import DenseIMParams, IMParams
from repro_torch.core.online import OnlineAMState
from repro_torch.device import resolve_device
from repro_torch.kernels.dense_hdc.ops import dense_encode_frames_fused
from repro_torch.kernels.dense_hdc.ops import encode_score_fused as dense_encode_score_fused
from repro_torch.kernels.hdc_am.ops import am_search
from repro_torch.kernels.hdc_encoder.ops import (encode_frames_fused, encode_score_fused,
                                                 frame_counts_fused)
from repro_torch.runtime.spans import span

VARIANTS = ("sparse_naive", "sparse_compim", "dense")

__all__ = ["HDCConfig", "HDCPipeline", "VARIANTS", "spatial_encode"]


def _check_cfg(cfg: HDCConfig) -> None:
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}; expected one of "
                         f"{VARIANTS}")


# ---------------------------------------------------------------------------
# variant-routed stages
# ---------------------------------------------------------------------------

def spatial_encode(params, codes: torch.Tensor, cfg: HDCConfig) -> torch.Tensor:
    """(..., channels) LBP codes -> (..., W) packed bundled HV, any variant
    (dense: XOR binding + per-bit channel majority)."""
    if cfg.variant == "dense":
        data = im_mod.im_lookup_packed(params, codes)            # (..., C, W)
        bound = binding.bind_xor(data, params.elec_packed)
        counts = hv.unpacked_counts(bound, axis=-2, dim=cfg.dim)
        return hv.majority_pack(counts, cfg.channels, cfg.dim)
    return classifier.spatial_encode(params, codes, cfg)


def _fused_sparse_cfg(cfg: HDCConfig) -> HDCConfig:
    """The sparse encoder kernel computes the position-domain datapath; the
    naive bit-domain variant is bit-identical to it with spatial thinning
    forced on at the naive threshold (binding-domain equivalence)."""
    if cfg.variant == "sparse_naive":
        return replace(cfg, spatial_thinning=True)
    return cfg


def _encode_frames(params, codes: torch.Tensor, cfg: HDCConfig) -> torch.Tensor:
    """(B, T, channels) uint8 codes -> (B, F, W) int32 frame HVs: the
    encoder kernels for CUDA tensors.  For CPU tensors the kernels' plain
    versions run, except for ``sparse_naive``, whose plain version is its
    own bit-domain datapath."""
    if cfg.variant == "dense":
        return dense_encode_frames_fused(params, codes, cfg)
    if cfg.variant == "sparse_naive" and codes.device.type == "cpu":
        return classifier.encode_frames(params, codes, cfg)
    return encode_frames_fused(params, codes, _fused_sparse_cfg(cfg))


def _am_mode(cfg: HDCConfig) -> str:
    return "hamming" if cfg.variant == "dense" else "overlap"


def _encode_score(params, codes: torch.Tensor, cfg: HDCConfig,
                  class_hvs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, channels) uint8 codes -> (scores (B, F, n_classes), predictions
    (B, F)): the encoder kernels with their AM epilogue for CUDA tensors, as
    ``_encode_frames`` routes the variants; for CPU tensors their plain
    versions, and ``sparse_naive``'s own bit-domain datapath scored by the
    AM's plain version."""
    if cfg.variant == "dense":
        return dense_encode_score_fused(params, codes, cfg, class_hvs)
    if cfg.variant == "sparse_naive" and codes.device.type == "cpu":
        s = am_search(classifier.encode_frames(params, codes, cfg), class_hvs,
                      mode=_am_mode(cfg), dim=cfg.dim)
        return s, am.am_predict(s)
    return encode_score_fused(params, codes, _fused_sparse_cfg(cfg), class_hvs)


def _frame_counts(params, codes: torch.Tensor, cfg: HDCConfig) -> torch.Tensor:
    """Temporal accumulator counts per frame (B, F, D) int32: for the sparse
    variants the encoder kernel with its counts epilogue on CUDA tensors,
    routed as ``_encode_frames`` routes them; dense (which never
    calibrates) and CPU tensors take the plain datapaths."""
    if cfg.variant == "dense":
        spatial = spatial_encode(params, classifier.frame_view(codes, cfg.window),
                                 cfg)
        return bundling.temporal_counts(spatial, cfg.dim)
    if cfg.variant == "sparse_naive" and codes.device.type == "cpu":
        return classifier.frame_counts(params, codes, cfg)
    return frame_counts_fused(params, codes, _fused_sparse_cfg(cfg))


def _fit_iterative(params, codes: torch.Tensor, labels: torch.Tensor,
                   margin: float, cfg: HDCConfig, epochs: int
                   ) -> tuple[torch.Tensor, OnlineAMState, torch.Tensor]:
    """One-shot init + ``epochs`` batch-iterative retraining passes: each
    epoch re-thresholds the counter file to class HVs, scores every frame
    through the standalone AM search and applies the gated update to all
    misclassified / low-margin frames at once.  The frames are encoded
    once, and no epoch reads the device from the host.  Returns (class
    HVs, state, (epochs,) int32 gated-update counts)."""
    with span("fit.encode"):
        frames = _encode_frames(params, codes, cfg)              # (B, F, W)
        flat = frames.reshape(-1, frames.shape[-1])
        bits = hv.unpack_bits(flat, cfg.dim)
        lab = labels.reshape(-1)
        state = online.state_from_frames(bits, lab, cfg.n_classes)
        n_upd = torch.zeros((epochs,), dtype=torch.int32, device=flat.device)
    for e in range(epochs):
        with span("fit.epoch"):
            chvs = online.class_hvs_from_state(state, cfg)
            scores = am_search(flat, chvs, mode=_am_mode(cfg), dim=cfg.dim)
            state, gate = online.batch_update(state, bits, lab, scores,
                                              margin=margin)
            n_upd[e] = gate.sum(dtype=torch.int32)
    return online.class_hvs_from_state(state, cfg), state, n_upd


# ---------------------------------------------------------------------------
# the pipeline object
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HDCPipeline:
    """IM params + (optional) trained class HVs and counter-file state."""
    params: IMParams | DenseIMParams
    cfg: HDCConfig
    class_hvs: torch.Tensor | None = None       # (n_classes, W) int32
    am_state: OnlineAMState | None = None

    @classmethod
    def init(cls, generator: torch.Generator, cfg: HDCConfig,
             device=None) -> "HDCPipeline":
        """Draw the codebooks for ``cfg.variant`` from ``generator``; place
        them on ``device`` (default: the CUDA card, raising when there is
        none)."""
        _check_cfg(cfg)
        dev = resolve_device(device)
        if cfg.variant == "dense":
            params = im_mod.make_dense_im(generator, channels=cfg.channels,
                                          codes=cfg.codes, dim=cfg.dim,
                                          device=dev)
        else:
            # only the naive bit-domain datapath reads the packed tables
            params = im_mod.make_im(
                generator, channels=cfg.channels, codes=cfg.codes,
                dim=cfg.dim, segments=cfg.segments, device=dev,
                precompute_packed=cfg.variant == "sparse_naive")
        return cls(params=params, cfg=cfg)

    @property
    def device(self) -> torch.device:
        return self.params.device

    def to(self, device) -> "HDCPipeline":
        return replace(
            self, params=self.params.to(device),
            class_hvs=None if self.class_hvs is None else self.class_hvs.to(device),
            am_state=None if self.am_state is None else self.am_state.to(device))

    # -- config rewrites ----------------------------------------------------

    # class HVs are trained through the same encoder as inference; changing
    # any of these on a trained pipeline drops them
    _ENCODER_FIELDS = ("variant", "spatial_thinning", "spatial_threshold",
                       "temporal_threshold", "class_density")
    _GEOMETRY_FIELDS = ("dim", "segments", "channels", "lbp_bits",
                        "n_classes", "window")

    def with_cfg(self, **overrides) -> "HDCPipeline":
        """Rebuild with config overrides that keep the params (variant
        within sparse or dense, thresholds; not the geometry).  Changing an
        encoder field on a trained pipeline drops the class HVs."""
        new = replace(self.cfg, **overrides)
        _check_cfg(new)
        for field in self._GEOMETRY_FIELDS:
            if getattr(new, field) != getattr(self.cfg, field):
                raise ValueError(f"cannot change {field} without re-init")
        if (new.variant == "dense") != (self.cfg.variant == "dense"):
            raise ValueError("cannot cross the sparse/dense params boundary; "
                             "HDCPipeline.init a new pipeline instead")
        chvs, state = self.class_hvs, self.am_state
        if chvs is not None and any(getattr(new, f) != getattr(self.cfg, f)
                                    for f in self._ENCODER_FIELDS):
            chvs = state = None
        params = self.params
        naive = new.variant == "sparse_naive"
        if new.variant != "dense" and (params.item_packed_cache is not None) != naive:
            # the packed caches follow the naive datapath, which reads them
            params = params.with_packed(naive)
        return replace(self, cfg=new, class_hvs=chvs, am_state=state,
                       params=params)

    # -- encode / calibrate / train / infer ---------------------------------

    def _codes(self, codes) -> torch.Tensor:
        return torch.as_tensor(codes, dtype=torch.uint8, device=self.device)

    def encode_frames(self, codes) -> torch.Tensor:
        """(B, T, channels) uint8 codes -> (B, F, W) int32 frame HVs."""
        return _encode_frames(self.params, self._codes(codes), self.cfg)

    def frame_counts(self, codes) -> torch.Tensor:
        """Pre-threshold temporal accumulator counts (B, F, D)."""
        return _frame_counts(self.params, self._codes(codes), self.cfg)

    def calibrate_density(self, codes, target: float) -> "HDCPipeline":
        """Program the temporal threshold so post-thinning frame density
        stays <= ``target`` on the calibration stream; nothing for the
        dense variant (majority, no thinning).  Calibrate before training:
        a changed threshold drops trained class HVs."""
        if self.cfg.variant == "dense":
            return self
        with span("calibrate"):
            new_cfg = classifier.with_density_target(
                self.params, self._codes(codes), self.cfg, target,
                counts_fn=_frame_counts)
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

    def fit_iterative(self, codes, labels, *, epochs: int = 5,
                      margin: float = 0.0) -> "HDCPipeline":
        """Iterative retraining (Pale et al.): one-shot init, then
        ``epochs`` passes that re-score every frame and apply the gated
        add-to-true / subtract-from-rival update to the counter file.
        ``margin > 0`` also updates on correct frames whose lead over the
        rival is below it; ``epochs=0`` equals ``train_one_shot``."""
        if epochs < 0:
            raise ValueError(f"epochs={epochs} must be >= 0")
        with span("fit"):
            labels = torch.as_tensor(labels, device=self.device)
            with span("fit.labels"):
                self._check_labels(labels)
            chvs, state, _ = _fit_iterative(self.params, self._codes(codes),
                                            labels, margin, self.cfg, epochs)
            return replace(self, class_hvs=chvs, am_state=state)

    def _trained(self) -> torch.Tensor:
        if self.class_hvs is None:
            raise ValueError("pipeline has no class HVs; call train_one_shot first")
        return self.class_hvs

    def scores(self, frames: torch.Tensor) -> torch.Tensor:
        """(..., W) frame HVs -> (..., n_classes) AM scores (overlap for the
        sparse variants, D - Hamming distance for dense), through the
        standalone AM kernel."""
        return am_search(frames, self._trained(), mode=_am_mode(self.cfg),
                         dim=self.cfg.dim)

    def infer(self, codes) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T, channels) codes -> (scores (B, F, n_classes),
        predictions (B, F) int32, argmax with ties to the lower class): on
        the card one launch of the encoder kernel with its AM epilogue."""
        with span("infer"):
            return _encode_score(self.params, self._codes(codes), self.cfg,
                                 self._trained())
