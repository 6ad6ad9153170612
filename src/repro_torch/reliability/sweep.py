"""Fleet-scale bit-error degradation sweeps, BER x variant x density x ECC
scheme (port of ``repro.reliability.sweep``).

How fast does seizure detection (accuracy, delay, false alarms) decay as the
raw bit-error rate of the accelerator's memories rises, and how much of that
does word-level ECC on the AM buy back, at what read energy?  The sweep
replays the same synthetic-patient test streams through a
``StreamingFleet`` at every grid point:

* one faulted fleet per (variant, density, scheme); ``set_ber`` + ``reset``
  walks the BER grid;
* the BER-0 point is checked bit-exact (every frame's scores) against a
  fault-free fleet over the same pipelines: ``zero_ber_bitexact``.

Variant names follow the reference's hardware model (dense, sparse_naive,
sparse_compim, sparse_opt); ``HW_VARIANTS`` maps them onto ``HDCConfig``.
Pipelines are drawn from ``torch.Generator``s on the sweep's device (the
card unless ``device="cpu"``), so their codebooks are the port's own, not
the reference's.  Points are plain dicts with the reference's keys.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.classifier import HDCConfig
from repro_torch.core.pipeline import HDCPipeline
from repro_torch.data import ieeg
from repro_torch.device import resolve_device
from repro_torch.reliability import ecc
from repro_torch.reliability.faults import TARGETS, FaultConfig
from repro_torch.serve.fleet import StreamingFleet

# hardware variant name -> HDCConfig overrides: "sparse_opt" is CompIM with
# the OR-tree spatial bundle, "sparse_compim" the thinned CompIM design
# point, "sparse_naive" always thins
HW_VARIANTS: dict[str, dict] = {
    "dense": {"variant": "dense", "spatial_thinning": False},
    "sparse_naive": {"variant": "sparse_naive", "spatial_thinning": True},
    "sparse_compim": {"variant": "sparse_compim", "spatial_thinning": True},
    "sparse_opt": {"variant": "sparse_compim", "spatial_thinning": False},
}


def variant_config(hw_variant: str, base: HDCConfig) -> HDCConfig:
    """Map a hardware variant name onto the pipeline config."""
    if hw_variant not in HW_VARIANTS:
        raise ValueError(f"variant {hw_variant!r} must be one of "
                         f"{sorted(HW_VARIANTS)}")
    return replace(base, **HW_VARIANTS[hw_variant])


# ---------------------------------------------------------------------------
# synthetic-patient session bank
# ---------------------------------------------------------------------------

def make_sessions(*, n_patients: int, n_test: int, channels: int,
                  record_kw: dict | None = None, seed: int = 0) -> dict:
    """The patient streams the whole sweep replays: per patient, record 0
    trains and records 1..n_test are test streams, one fleet session each,
    stacked to (S, T, channels) (equal T: fixed record durations)."""
    record_kw = dict(record_kw or {})
    record_kw["channels"] = channels
    train, tests, owners = {}, [], []
    for pid in range(n_patients):
        rng = np.random.default_rng(7000 + seed + pid)
        recs = [ieeg.make_record(rng, **record_kw) for _ in range(1 + n_test)]
        train[f"p{pid}"] = recs[0]
        for rec in recs[1:]:
            tests.append(rec)
            owners.append(f"p{pid}")
    batch = np.stack([r.codes for r in tests])  # (S, T, channels)
    return {"train": train, "tests": tests, "owners": owners, "batch": batch}


def train_pipelines(hw_variant: str, density: float, sessions: dict,
                    base_cfg: HDCConfig, *, seed: int = 0, device=None
                    ) -> tuple[dict[str, HDCPipeline], HDCConfig]:
    """One-shot pipelines per patient at this (variant, density) point, on
    ``device`` (default: the card).  ``calibrate_density`` sets the temporal
    threshold before training (nothing for dense)."""
    cfg = variant_config(hw_variant, base_cfg)
    dev = resolve_device(device)
    pipes: dict[str, HDCPipeline] = {}
    for i, (name, rec) in enumerate(sessions["train"].items()):
        codes = torch.as_tensor(rec.codes[None], device=dev)
        labels = ieeg.frame_labels(rec, cfg.window)[None]
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        pipe = HDCPipeline.init(gen, cfg, device=dev)
        pipe = pipe.calibrate_density(codes, target=density)
        pipes[name] = pipe.train_one_shot(codes, labels)
    return pipes, cfg


# ---------------------------------------------------------------------------
# fleet replay
# ---------------------------------------------------------------------------

def replay(fleet: StreamingFleet, batch: np.ndarray
           ) -> tuple[np.ndarray, np.ndarray]:
    """Reset, then stream the stacked test batch; returns per-session
    ``(preds (S, F) int32, scores (S, F, C) float32)``."""
    fleet.reset()
    decs = fleet.push_codes(batch)
    preds = np.asarray([[d.prediction for d in ds] for ds in decs], np.int32)
    scores = np.asarray([[d.scores for d in ds] for ds in decs], np.float32)
    return preds, scores


def detection_summary(preds: np.ndarray, sessions: dict, cfg: HDCConfig
                      ) -> dict:
    """k-of-m post-processed detection metrics over all fleet sessions."""
    res = [
        metrics.detection_metrics(
            preds[s], ieeg.onset_frame(rec, cfg.window),
            frame_seconds=cfg.window / ieeg.FS)
        for s, rec in enumerate(sessions["tests"])
    ]
    return metrics.aggregate(res)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _fault_config(targets, mode: str, scheme: str, seed: int,
                  counts_bits: int | None = None) -> FaultConfig:
    bad = set(targets) - set(TARGETS)
    if bad:
        raise ValueError(f"unknown fault targets {sorted(bad)}; "
                         f"pick from {TARGETS}")
    kw = {t: (0.0 if t in targets else None) for t in TARGETS}
    return FaultConfig(mode=mode, seed=seed, ecc=scheme,
                       counts_bits=counts_bits, **kw)


def run_sweep(*, variants=("sparse_opt",), densities=(0.25,),
              bers=(0.0, 1e-3, 1e-2), schemes=("none",),
              targets=("tables", "am", "counts"), mode: str = "transient",
              base_cfg: HDCConfig, n_patients: int = 2, n_test: int = 2,
              record_kw: dict | None = None, seed: int = 0,
              counts_bits: int | None = None, device=None) -> list[dict]:
    """Degradation grid: variant x density x ECC scheme x BER, on ``device``
    (default: the card).

    One faulted fleet per (variant, density, scheme), the BER moved by
    ``set_ber``.  Each point carries the detection metrics, the frame-level
    disagreement with the clean run, the cumulative ECC word counts and the
    ECC read energy and overhead (``ecc.read_energy_nj``,
    ``ecc.read_overhead``).  BER-0 points also carry ``zero_ber_bitexact``,
    every score equal to a fault-free fleet's: callers treat False as an
    error."""
    dev = resolve_device(device)
    sessions = make_sessions(n_patients=n_patients, n_test=n_test,
                             channels=base_cfg.channels,
                             record_kw=record_kw, seed=seed)
    batch, owners = sessions["batch"], sessions["owners"]
    points: list[dict] = []
    for hw in variants:
        for density in densities:
            pipes, cfg = train_pipelines(hw, density, sessions, base_cfg,
                                         seed=seed, device=dev)
            buckets = (cfg.window,)
            clean = StreamingFleet(pipes, owners, buckets=buckets)
            clean_preds, clean_scores = replay(clean, batch)
            clean_agg = detection_summary(clean_preds, sessions, cfg)
            for scheme in schemes:
                fc = _fault_config(targets, mode, scheme, seed,
                                   counts_bits=counts_bits)
                fleet = StreamingFleet(pipes, owners, buckets=buckets,
                                       faults=fc)
                n_frames = clean_preds.size
                for ber in bers:
                    fleet.set_ber(float(ber))
                    preds, scores = replay(fleet, batch)
                    agg = detection_summary(preds, sessions, cfg)
                    st = fleet.ecc_stats.sum(axis=0)
                    point = {
                        "variant": hw, "density": float(density),
                        "scheme": scheme, "ber": float(ber), "mode": mode,
                        "targets": list(targets),
                        "sessions": len(owners), "frames": int(n_frames),
                        "detection_accuracy": agg["detection_accuracy"],
                        "mean_delay_s": agg["mean_delay_s"],
                        "false_alarm_rate": agg["false_alarm_rate"],
                        "clean_detection_accuracy":
                            clean_agg["detection_accuracy"],
                        "frame_disagreement":
                            float(np.mean(preds != clean_preds)),
                        "ecc_corrected": int(st[0]),
                        "ecc_detected": int(st[1]),
                        "ecc_uncorrectable": int(st[2]),
                        "ecc_read_energy_nj": ecc.read_energy_nj(
                            scheme, cfg.n_classes, cfg.words),
                        "ecc_read_overhead": ecc.read_overhead(
                            scheme, cfg.n_classes, cfg.words),
                    }
                    if ber == 0.0:
                        point["zero_ber_bitexact"] = bool(
                            np.array_equal(preds, clean_preds)
                            and np.array_equal(scores, clean_scores))
                    points.append(point)
    return points
