"""Serving records (port of ``repro.serve.engine.FrameDecision``; the
batched engine and single sessions are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FrameDecision:
    frame_index: int
    scores: np.ndarray        # (n_classes,) int32
    prediction: int           # argmax class id
    frame_hv: np.ndarray      # (W,) uint32 packed
