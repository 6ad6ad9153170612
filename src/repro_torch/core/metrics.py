"""Detection metrics: detection delay and seizure detection accuracy.

A numpy copy of ``repro.core.metrics`` (the port imports nothing of the
reference package).

Paper Sec. IV-A: delay is measured from the expert-marked seizure onset to the
first ictal-classified time frame; accuracy is the fraction of test seizures
detected.  Like the Burrello system we smooth single-frame flickers with a
k-of-m post-processing vote before declaring a detection.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DetectionResult:
    detected: bool
    delay_frames: float          # frames after onset (nan if undetected)
    false_alarm: bool            # any detection before onset
    delay_seconds: float = float("nan")


def postprocess(preds: np.ndarray, k: int = 2, m: int = 3) -> np.ndarray:
    """k-of-m smoothing: frame f fires iff it is ictal AND >= k of the last m
    predictions are ictal.  The stream start pads with interictal frames, so
    the FULL k votes are always required — frames 0..k-2 can never fire.
    (The old ``min(k, f - lo + 1)`` relaxation degenerated to 1-of-1 at
    frame 0: a single ictal flicker fired the detector, inflating both
    detection accuracy and the false-alarm rate at record boundaries.)
    """
    if not 1 <= k <= m:
        raise ValueError(f"need 1 <= k <= m, got k={k}, m={m}")
    preds = np.asarray(preds).astype(np.int32)
    out = np.zeros_like(preds)
    for f in range(len(preds)):
        lo = max(0, f - m + 1)
        out[f] = int(preds[f] == 1 and preds[lo:f + 1].sum() >= k)
    return out


def detection_metrics(preds: np.ndarray, onset_frame: int, *, k: int = 2,
                      m: int = 3, frame_seconds: float = 0.5,
                      horizon_frames: int | None = None) -> DetectionResult:
    """preds: (F,) 0/1 per-frame classifications of one test seizure record."""
    fired = postprocess(preds, k=k, m=m)
    post = np.nonzero(fired[onset_frame:])[0]
    pre = np.nonzero(fired[:onset_frame])[0]
    detected = len(post) > 0
    if horizon_frames is not None and detected:
        detected = post[0] <= horizon_frames
    delay = float(post[0]) if detected else float("nan")
    return DetectionResult(
        detected=bool(detected),
        delay_frames=delay,
        false_alarm=len(pre) > 0,
        delay_seconds=delay * frame_seconds if detected else float("nan"),
    )


def aggregate(results: list[DetectionResult]) -> dict:
    """Average delay over detected seizures + detection accuracy (paper Fig. 4)."""
    delays = [r.delay_seconds for r in results if r.detected]
    return {
        "detection_accuracy": float(np.mean([r.detected for r in results])) if results else 0.0,
        "mean_delay_s": float(np.mean(delays)) if delays else float("nan"),
        "false_alarm_rate": float(np.mean([r.false_alarm for r in results])) if results else 0.0,
        "n": len(results),
    }
