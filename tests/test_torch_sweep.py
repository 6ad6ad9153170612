"""The port's degradation sweep (``reliability/sweep.py``) held against the
JAX package's: ``make_sessions``, ``replay`` and ``detection_summary`` with
the reference's pipelines transferred, and ``run_sweep``'s points.

Tolerance: exact equality.  The sessions are the same numpy records; the
fleets are integer and bit arithmetic.  ``run_sweep`` draws the port's own
codebooks, so its points are compared with the reference's in their keys,
their energy fields and the BER-0 bit-exactness gate, not in their
detection numbers.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.core.pipeline import HDCConfig as JConfig
from repro.reliability import sweep as j_sweep
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.core.classifier import HDCConfig
from repro_torch.reliability import sweep
from repro_torch.serve.fleet import StreamingFleet
from test_torch_monitor import SHORT, _raises_alike
from test_torch_online import CHANNELS, WINDOW, _transfer

jax.config.update("jax_platform_name", "cpu")

BASE = dict(dim=256, segments=8, channels=CHANNELS, window=WINDOW, temporal_threshold=4)


def _sessions():
    kw = dict(n_patients=2, n_test=2, channels=CHANNELS, record_kw=SHORT, seed=1)
    return sweep.make_sessions(**kw), j_sweep.make_sessions(**kw)


def _same_metric(a, b) -> bool:
    return a == b or (isinstance(a, float) and math.isnan(a) and math.isnan(b))


def test_make_sessions_matches_reference():
    got, want = _sessions()
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["batch"], want["batch"])
    assert got["owners"] == want["owners"]
    for k in want["train"]:
        np.testing.assert_array_equal(got["train"][k].codes, want["train"][k].codes)
    for a, b in zip(got["tests"], want["tests"]):
        assert a.onset_sample == b.onset_sample
        np.testing.assert_array_equal(a.label, b.label)


@pytest.mark.parametrize("hw", ["sparse_opt", "dense"])
def test_replay_and_summary_match_reference(hw):
    """The reference's pipelines (``train_pipelines``) transferred into the
    port: ``replay`` of the test batch through each package's fleet (the
    port's faulted at BER 0) gives equal predictions and scores, and
    ``detection_summary`` equal metrics."""
    sessions, j_sessions = _sessions()
    jcfg = JConfig(backend="jnp", **BASE)
    jpipes, jc = j_sweep.train_pipelines(hw, 0.3, j_sessions, jcfg, seed=2)
    tpipes = {k: _transfer(v) for k, v in jpipes.items()}
    tcfg = sweep.variant_config(hw, HDCConfig(**BASE))
    assert dataclasses.asdict(tcfg) == {k: v for k, v in dataclasses.asdict(
        j_sweep.variant_config(hw, jcfg)).items() if k != "backend"}
    owners = sessions["owners"]
    ref = JFleet(jpipes, owners, buckets=(WINDOW,), backend="jnp")
    port = StreamingFleet(tpipes, owners, buckets=(WINDOW,),
                          faults=sweep._fault_config(("tables", "am", "counts"),
                                                     "transient", "secded", 0))
    (gp, gs), (wp, ws) = sweep.replay(port, sessions["batch"]), \
        j_sweep.replay(ref, j_sessions["batch"])
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gs, ws)
    assert gp.dtype == np.int32 and gs.dtype == np.float32
    got = sweep.detection_summary(gp, sessions, tpipes["p0"].cfg)
    want = j_sweep.detection_summary(wp, j_sessions, jc)
    assert got.keys() == want.keys()
    assert all(_same_metric(got[k], want[k]) for k in want), (got, want)


def test_run_sweep_points_match_reference():
    """A small sweep on the CPU: the port's points have the reference's
    keys in the same order, equal energy fields and grid coordinates, and
    every BER-0 point is bit-exact with the clean fleet.  The reference
    runs the SECDED half of the grid."""
    kw = dict(variants=("sparse_opt",), densities=(0.3,), bers=(0.0, 1e-2),
              n_patients=1, n_test=2, record_kw=SHORT)
    got = sweep.run_sweep(base_cfg=HDCConfig(**BASE), device="cpu",
                          schemes=("none", "secded"), **kw)
    want = j_sweep.run_sweep(base_cfg=JConfig(backend="jnp", **BASE), schemes=("secded",), **kw)
    assert [(p["scheme"], p["ber"]) for p in got] == \
        [("none", 0.0), ("none", 1e-2), ("secded", 0.0), ("secded", 1e-2)]
    for g, w in zip(got[2:], want):
        assert list(g) == list(w)
        for k in ("variant", "density", "scheme", "ber", "mode", "targets", "sessions",
                  "frames", "ecc_read_energy_nj", "ecc_read_overhead"):
            assert g[k] == w[k], k
    for g in got:
        assert list(g) == list(want[0] if g["ber"] == 0.0 else want[1])
        if g["ber"] == 0.0:
            assert g["zero_ber_bitexact"] is True
            assert g["frame_disagreement"] == 0.0 and g["ecc_detected"] == 0
    assert want[0]["zero_ber_bitexact"] is True
    assert got[0]["ecc_read_energy_nj"] == 0.0 and got[1]["ecc_corrected"] == 0
    assert got[-1]["ecc_corrected"] > 0
    _raises_alike(sweep.variant_config, j_sweep.variant_config, "sparse_best",
                  HDCConfig(**BASE))
    _raises_alike(sweep._fault_config, j_sweep._fault_config, ("cache",), "transient",
                  "none", 0)
    assert sweep.HW_VARIANTS == j_sweep.HW_VARIANTS


def test_sweep_pipelines_live_on_the_requested_device():
    sessions, _ = _sessions()
    pipes, cfg = sweep.train_pipelines("sparse_compim", 0.3, sessions,
                                       HDCConfig(**BASE), device="cpu")
    assert cfg.spatial_thinning and set(pipes) == {"p0", "p1"}
    assert all(p.device.type == "cpu" and p.class_hvs is not None for p in pipes.values())
    again, _ = sweep.train_pipelines("sparse_compim", 0.3, sessions, HDCConfig(**BASE),
                                     device="cpu")
    assert all((again[k].class_hvs == p.class_hvs).all() for k, p in pipes.items())
