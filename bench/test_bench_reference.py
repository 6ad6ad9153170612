"""At small sizes on the CPU the bench's plain reference equals the port's
plain paths: piece by piece, and over whole runs of each cell."""

import numpy as np
import pytest
import torch

from bench import codebooks, harness, ieeg_gen
from bench.conftest import SEED, TINY
from bench.reference import hdc as ref
from repro_torch.core import bundling, classifier, hv
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.kernels.lbp.ref import lbp_ref

HDC = {"sparse_compim": dict(dim=1024, segments=8, channels=64, lbp_bits=6, window=256,
                             variant="sparse_compim", spatial_thinning=False,
                             spatial_threshold=2, temporal_threshold=130, n_classes=2,
                             class_density=0.5)}
HDC["dense"] = dict(HDC["sparse_compim"], variant="dense")
HDC["thinned"] = dict(HDC["sparse_compim"], spatial_thinning=True, spatial_threshold=3)


def _signal(t=256 * 12 + 6, c=64, seizures=((700, 1500),), key=("ref",)):
    pat = ieeg_gen.patient(SEED, 0, c)
    x = ieeg_gen.recording(SEED, key, pat, t, c, list(seizures), "cpu")
    lab = ieeg_gen.frame_labels(list(seizures), t - 6, 256)
    return x, torch.as_tensor(lab)


def test_lbp_equals_the_ports():
    x, _ = _signal()
    assert torch.equal(ref.lbp(x, 6), lbp_ref(x.unsqueeze(0), bits=6)[0])


@pytest.mark.parametrize("name", ["sparse_compim", "thinned"])
def test_sparse_counts_and_threshold_equal_the_ports(name):
    hdc = HDC[name]
    x, _ = _signal()
    book = codebooks.draw(SEED, ("p",), hdc, "cpu")
    codes = ref.lbp(x, 6)
    params = codebooks.to_program(book, hdc)
    cfg = HDCConfig(**hdc)
    mine = ref.sparse_counts(codes, book["item"], book["elec"], hdc, block=5)
    port = classifier.frame_counts(params, codes.unsqueeze(0), cfg)[0]
    assert torch.equal(mine, port)
    for target in (0.1, 0.25, 0.3):
        assert ref.calib_threshold(mine, target) == int(
            bundling.threshold_for_density(port.unsqueeze(0), target))


def test_dense_bits_equal_the_ports():
    hdc = HDC["dense"]
    x, _ = _signal()
    book = codebooks.draw(SEED, ("p",), hdc, "cpu")
    codes = ref.lbp(x, 6)
    pipe = HDCPipeline(params=codebooks.to_program(book, hdc), cfg=HDCConfig(**hdc))
    port = pipe.encode_frames(codes.unsqueeze(0))[0]
    assert torch.equal(ref.pack(ref.dense_bits(codes, book["item"], book["elec"], hdc,
                                               block=5)), port)


@pytest.mark.parametrize("name", ["sparse_compim", "dense"])
def test_training_and_scores_equal_the_ports(name):
    hdc = HDC[name]
    x, lab = _signal(t=256 * 24 + 6, seizures=((1000, 2000), (3600, 1500)))
    book = codebooks.draw(SEED, ("p",), hdc, "cpu")
    codes = ref.lbp(x, 6)
    pipe = HDCPipeline(params=codebooks.to_program(book, hdc), cfg=HDCConfig(**hdc))
    thr = hdc["temporal_threshold"]
    if name != "dense":
        pipe = pipe.calibrate_density(codes.unsqueeze(0), target=0.25)
        thr = ref.calib_threshold(ref.sparse_counts(codes, book["item"], book["elec"], hdc),
                                  0.25)
        assert pipe.cfg.temporal_threshold == thr
    bits = ref.frame_bits(codes, book, hdc, thr)
    assert torch.equal(ref.pack(bits), pipe.encode_frames(codes.unsqueeze(0))[0])
    for epochs in (0, 1, 3):
        fit = pipe.fit_iterative(codes.unsqueeze(0), lab.unsqueeze(0), epochs=epochs)
        cbits, counts, n = ref.fit(bits, lab, hdc, epochs)
        assert torch.equal(ref.pack(cbits), fit.class_hvs)
        assert torch.equal(counts, fit.am_state.counts) and torch.equal(n, fit.am_state.n)
    scores, preds = fit.infer(codes.unsqueeze(0))
    mine = ref.am_scores(bits, cbits, hdc)
    assert torch.equal(mine, scores[0]) and torch.equal(ref.predict(mine), preds[0])


def test_predict_breaks_ties_to_the_lower_class():
    s = torch.tensor([[3, 3], [1, 2], [5, 4], [2, 2]], dtype=torch.int32)
    assert ref.predict(s).tolist() == [0, 1, 0, 0]


def test_unpack_and_pack_are_the_ports_bit_order():
    g = torch.Generator().manual_seed(3)
    w = torch.randint(-2**31, 2**31 - 1, (6, 32), generator=g, dtype=torch.int64)
    w = w.to(torch.int32)
    assert torch.equal(ref.unpack(w, 1024), hv.unpack_bits(w, 1024).bool())
    assert torch.equal(ref.pack(ref.unpack(w, 1024)), w)


@pytest.mark.parametrize("cell", ["compim.review", "dense.review", "compim.onboard"])
def test_a_whole_run_is_correct(cell):
    kind = "onboard" if cell.endswith("onboard") else "review"
    res = harness.run(cell, SEED, 0.3, False, device="cpu", traffic_overrides=TINY[kind])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) >= {"setup_s"}
    assert np.isfinite([m["value"] for m in res["metrics"].values()]).all()
