"""The paper's own system: sparse HDC iEEG seizure-detection classifier.

Paper-exact parameters (Sec. II / IV-B): D=1024, 8 segments (one 1-bit each,
p = 0.78%), 64 electrodes, 6-bit LBP codes, 256-cycle temporal window,
temporal threshold 130 (20-30% max density operating point — the purple
star of Fig. 4), spatial bundling WITHOUT thinning (the proposed design),
2 classes, one-shot training with 50% class-HV density.

Variants (``HDCConfig.variant``):
  sparse_compim  (default) the optimized accelerator (CompIM + OR bundling)
  sparse_naive   the baseline accelerator (Fig. 3a)
  dense          the dense-HDC comparison system of [1]
All three are routed by the unified repro_torch.core.pipeline.HDCPipeline
surface; the tensors' device selects the CUDA kernels or their plain
versions.
"""

from repro_torch.core.classifier import HDCConfig

CONFIG = HDCConfig(
    dim=1024,
    segments=8,
    channels=64,
    lbp_bits=6,
    window=256,
    variant="sparse_compim",
    spatial_thinning=False,
    temporal_threshold=130,
    n_classes=2,
    class_density=0.5,
)

BASELINE = HDCConfig(
    dim=1024, segments=8, channels=64, lbp_bits=6, window=256,
    variant="sparse_naive", spatial_thinning=True, spatial_threshold=1,
    temporal_threshold=130, n_classes=2, class_density=0.5,
)
