"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped (the plain paths on the CPU), every other
step of a run driven, one planted fault at a time."""

import dataclasses

import pytest
import torch

from bench import harness
from bench.conftest import SEED, TINY
from repro_torch.core.pipeline import HDCPipeline

_infer = HDCPipeline.infer
_train = HDCPipeline.train_one_shot
_fit = HDCPipeline.fit_iterative
_calibrate = HDCPipeline.calibrate_density


def _half_infer(self, codes):
    """Half of the frames left out."""
    codes = torch.as_tensor(codes)
    keep = codes.shape[1] // self.cfg.window // 2 * self.cfg.window
    return _infer(self, codes[:, :keep])


def _altered_infer(self, codes):
    """One answer changed where it is produced."""
    scores, preds = _infer(self, codes)
    preds = preds.clone()
    preds[:, 0] = 1 - preds[:, 0]
    return scores, preds


def _frozen_train(self, codes, labels):
    """The training step returns the bank's state unchanged (untrained)."""
    trained = _train(self, codes, labels)
    return dataclasses.replace(trained, class_hvs=torch.zeros_like(trained.class_hvs))


def _frozen_fit(self, codes, labels, *, epochs=5, margin=0.0):
    """The retraining epochs return the state unchanged."""
    return _fit(self, codes, labels, epochs=0, margin=margin)


def _half_fit(self, codes, labels, *, epochs=5, margin=0.0):
    """Half of the frames left out of training."""
    labels = torch.as_tensor(labels)
    half = labels.shape[1] // 2
    return _fit(self, codes[:, :half * self.cfg.window], labels[:, :half], epochs=epochs,
                margin=margin)


def _altered_calibrate(self, codes, target):
    """The calibrated threshold changed where it is produced."""
    pipe = _calibrate(self, codes, target)
    return pipe.with_cfg(temporal_threshold=pipe.cfg.temporal_threshold + 1)


FAULTS = {
    "review": {"half": ("infer", _half_infer), "altered": ("infer", _altered_infer),
               "frozen": ("train_one_shot", _frozen_train)},
    "onboard": {"frozen": ("fit_iterative", _frozen_fit), "half": ("fit_iterative", _half_fit),
                "altered": ("calibrate_density", _altered_calibrate)},
}
CASES = [(cell, fault) for cell in ("compim.review", "dense.review", "compim.onboard")
         for fault in FAULTS["onboard" if cell.endswith("onboard") else "review"]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    kind = "onboard" if cell.endswith("onboard") else "review"
    attr, broken = FAULTS[kind][fault]
    monkeypatch.setattr(HDCPipeline, attr, broken)
    res = harness.run(cell, SEED + 1, 0.3, False, device="cpu", traffic_overrides=TINY[kind])
    assert not res["correct"], res["checks"]
    # every sampled recording or job was answered: what fails is the answers
    served = {k: c for k, c in res["checks"].items()
              if k in ("recordings_unserved", "jobs_missing")}
    assert all(c["value"] == 0 for c in served.values()), served
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
