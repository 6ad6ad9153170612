"""The port's offline chain — data, LBP, calibrate, one-shot train, infer,
detection metrics — held against the JAX package's ``HDCPipeline``
(``backend="jnp"``) with the codebooks transferred through
``repro_torch.convert``.

Tolerance: exact equality.  Calibration's float32 quantile rule is
repeated operation for operation, so the integer thresholds agree; every
other stage is integer or bit arithmetic.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as j_metrics
from repro.core.pipeline import HDCConfig as JConfig
from repro.core.pipeline import HDCPipeline as JPipeline
from repro.data import ieeg as j_ieeg
from repro_torch import convert
from repro_torch.core import hv, metrics
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.data import ieeg
from repro_torch.kernels.lbp.ops import lbp_codes

jax.config.update("jax_platform_name", "cpu")

REC = dict(pre_s=2.0, ictal_s=3.0, post_s=1.0)


def _records(mod, seed, channels, n=3, transform=None):
    rng = np.random.default_rng(seed)
    return [mod.make_record(rng, channels=channels, signal_transform=transform,
                            **REC) for _ in range(n)]


def _transfer(jp: JPipeline, device="cpu") -> HDCPipeline:
    kw = {}
    if jp.class_hvs is not None:
        kw = dict(class_hvs=np.asarray(jp.class_hvs),
                  am_counts=np.asarray(jp.am_state.counts),
                  am_n=np.asarray(jp.am_state.n))
    if jp.cfg.variant == "dense":
        books = jp.params.item_packed, jp.params.elec_packed
    else:
        books = jp.params.item_pos, jp.params.elec_pos
    return convert.pipeline_from_arrays(
        dataclasses.asdict(jp.cfg), *map(np.asarray, books), device=device, **kw)


# ---------------------------------------------------------------------------
# data and metrics copies
# ---------------------------------------------------------------------------

def test_data_copy_matches_reference_and_lbp_recovers_codes():
    """Same seed, same records; the identity transform hands back the raw
    signal, whose LBP codes equal the record's numpy codes."""
    signals = []

    def keep(x, rng):
        signals.append(x)
        return x

    ours = _records(ieeg, 3, 6, transform=keep)
    ref = _records(j_ieeg, 3, 6)
    for a, b, x in zip(ours, ref, signals):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.label, b.label)
        assert a.onset_sample == b.onset_sample
        got = lbp_codes(torch.from_numpy(x.T.copy())[None], bits=6)[0]
        np.testing.assert_array_equal(got.numpy(), a.codes)
    for window in (32, 256):
        np.testing.assert_array_equal(ieeg.frame_labels(ours[0], window),
                                      j_ieeg.frame_labels(ref[0], window))
        assert ieeg.onset_frame(ours[0], window) == j_ieeg.onset_frame(ref[0], window)


def test_make_patient_copy_matches_reference():
    a = ieeg.make_patient(5, n_seizures=1, channels=4)
    b = j_ieeg.make_patient(5, n_seizures=1, channels=4)
    np.testing.assert_array_equal(a.records[0].codes, b.records[0].codes)


@pytest.mark.parametrize("k,m", [(2, 3), (1, 1), (3, 4)])
def test_metrics_copy_matches_reference(k, m):
    rng = np.random.default_rng(k * 10 + m)
    res_a, res_b = [], []
    for _ in range(6):
        preds = rng.integers(0, 2, 40)
        onset = int(rng.integers(0, 40))
        np.testing.assert_array_equal(metrics.postprocess(preds, k=k, m=m),
                                      j_metrics.postprocess(preds, k=k, m=m))
        a = metrics.detection_metrics(preds, onset, k=k, m=m, horizon_frames=10)
        b = j_metrics.detection_metrics(preds, onset, k=k, m=m, horizon_frames=10)
        assert dataclasses.astuple(a) == pytest.approx(dataclasses.astuple(b), nan_ok=True)
        res_a.append(a)
        res_b.append(b)
    assert metrics.aggregate(res_a) == pytest.approx(j_metrics.aggregate(res_b), nan_ok=True)


# ---------------------------------------------------------------------------
# the offline chain
# ---------------------------------------------------------------------------

def _check_chain(cfg_kw: dict, n_records: int = 3) -> None:
    """Calibrate, frame counts, one-shot training, encode, scores,
    predictions and detection metrics against the reference's jnp path."""
    channels, window = cfg_kw["channels"], cfg_kw["window"]
    recs = _records(j_ieeg, channels, channels, n=n_records)
    train = recs[0]
    codes = train.codes[None]
    labels = j_ieeg.frame_labels(train, window)[None]
    jp = JPipeline.init(jax.random.PRNGKey(channels), JConfig(backend="jnp", **cfg_kw))
    tp = _transfer(jp)
    assert tp.cfg == HDCConfig(**cfg_kw)

    for target in (0.15, 0.25, 0.4):
        assert (tp.calibrate_density(codes, target).cfg.temporal_threshold
                == jp.calibrate_density(jnp.asarray(codes), target).cfg.temporal_threshold)
    np.testing.assert_array_equal(tp.frame_counts(codes).numpy(),
                                  np.asarray(jp.frame_counts(jnp.asarray(codes))))
    jp = jp.calibrate_density(jnp.asarray(codes), 0.25)
    tp = tp.calibrate_density(codes, 0.25)
    jp = jp.train_one_shot(jnp.asarray(codes), jnp.asarray(labels))
    tp = tp.train_one_shot(codes, labels)
    np.testing.assert_array_equal(hv.to_u32(tp.class_hvs), np.asarray(jp.class_hvs))
    np.testing.assert_array_equal(tp.am_state.counts.numpy(), np.asarray(jp.am_state.counts))
    np.testing.assert_array_equal(tp.am_state.n.numpy(), np.asarray(jp.am_state.n))

    test = np.stack([r.codes for r in recs[1:]])
    js, jpred = jp.infer(jnp.asarray(test))
    ts, tpred = tp.infer(test)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    frames = tp.encode_frames(test)
    np.testing.assert_array_equal(hv.to_u32(frames),
                                  np.asarray(jp.encode_frames(jnp.asarray(test))))
    np.testing.assert_array_equal(tp.scores(frames).numpy(),
                                  np.asarray(jp.scores(jp.encode_frames(jnp.asarray(test)))))
    for i, rec in enumerate(recs[1:]):
        onset = j_ieeg.onset_frame(rec, window)
        assert (dataclasses.astuple(metrics.detection_metrics(tpred[i].numpy(), onset))
                == pytest.approx(dataclasses.astuple(j_metrics.detection_metrics(
                    np.asarray(jpred[i]), onset)), nan_ok=True))


@pytest.mark.parametrize("channels,window,thinning", [(6, 32, False),
                                                      (7, 64, False),
                                                      (6, 32, True)])
def test_pipeline_chain_matches_reference(channels, window, thinning):
    _check_chain(dict(dim=256, segments=8, channels=channels, window=window,
                      spatial_thinning=thinning, spatial_threshold=2))


@pytest.mark.parametrize("variant,channels,window", [
    ("dense", 6, 32), ("dense", 7, 40), ("sparse_naive", 5, 32),
    ("sparse_naive", 6, 40)])
def test_variant_chain_matches_reference(variant, channels, window):
    """The dense and naive datapaths, at a window that is a multiple of 16
    and at one that is not (window 40)."""
    _check_chain(dict(dim=256, segments=8, channels=channels, window=window,
                      variant=variant, spatial_threshold=2),
                 n_records=3 if variant == "dense" else 2)


def _trained_pair(variant: str):
    cfg = JConfig(dim=256, segments=8, channels=4, window=32,
                  temporal_threshold=7, variant=variant)
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 64, (1, 4 * 32, 4), dtype=np.uint8)
    labels = np.asarray([[0, 1, 0, 1]])
    jp = JPipeline.init(jax.random.PRNGKey(5), cfg).train_one_shot(
        jnp.asarray(codes), jnp.asarray(labels))
    return jp, _transfer(jp)


@pytest.mark.parametrize("variant", ["sparse_compim", "sparse_naive", "dense"])
def test_with_cfg_variant_rules_match_reference(variant):
    """Crossing sparse/dense and changing the geometry raise; an encoder
    field drops the class HVs; the packed caches follow sparse_naive."""
    jp, tp = _trained_pair(variant)
    sparse = ("sparse_compim", "sparse_naive")
    overrides = [dict(temporal_threshold=7), dict(temporal_threshold=8),
                 dict(class_density=0.3), dict(spatial_threshold=3),
                 dict(variant="dense"), dict(window=64), dict(channels=5),
                 dict(variant="bogus")] + [dict(variant=v) for v in sparse]
    for ov in overrides:
        try:
            jnew = jp.with_cfg(**ov)
        except ValueError as exc:
            with pytest.raises(ValueError, match=re.escape(str(exc)[:20])):
                tp.with_cfg(**ov)
            continue
        tnew = tp.with_cfg(**ov)
        assert dataclasses.replace(jnew.cfg, backend="jnp") == JConfig(
            **dataclasses.asdict(tnew.cfg), backend="jnp"), ov
        assert (tnew.class_hvs is None) == (jnew.class_hvs is None), ov
        assert (tnew.am_state is None) == (jnew.am_state is None), ov
        if variant != "dense":
            assert ((tnew.params.item_packed_cache is None)
                    == (jnew.params.item_packed_cache is None)), ov
            assert ((tnew.params.elec_packed_cache is None)
                    == (jnew.params.elec_packed_cache is None)), ov
            if tnew.params.item_packed_cache is not None:
                np.testing.assert_array_equal(
                    hv.to_u32(tnew.params.item_packed_cache),
                    np.asarray(jnew.params.item_packed_cache))


def test_transferred_trained_pipeline_scores_like_reference():
    """A trained reference pipeline carried across whole (class HVs and
    counter file) infers identically."""
    cfg = JConfig(dim=256, segments=8, channels=6, window=32, temporal_threshold=9)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 64, (2, 4 * 32, 6), dtype=np.uint8)
    labels = np.asarray([[0, 1, 0, 1], [1, 1, 0, 0]])
    jp = JPipeline.init(jax.random.PRNGKey(4), cfg).train_one_shot(
        jnp.asarray(codes), jnp.asarray(labels))
    tp = _transfer(jp)
    np.testing.assert_array_equal(hv.to_u32(tp.class_hvs), np.asarray(jp.class_hvs))
    test = rng.integers(0, 64, (3, 5 * 32 + 3, 6), dtype=np.uint8)
    np.testing.assert_array_equal(tp.infer(test)[0].numpy(),
                                  np.asarray(jp.infer(jnp.asarray(test))[0]))


def test_pipeline_guards():
    cfg = HDCConfig(dim=256, channels=4, window=32)
    pipe = HDCPipeline.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    codes = np.random.default_rng(0).integers(0, 64, (1, 96, 4), dtype=np.uint8)
    with pytest.raises(ValueError, match="no class HVs"):
        pipe.infer(codes)
    with pytest.raises(ValueError, match="no examples"):
        pipe.train_one_shot(codes, np.zeros((1, 3), np.int64))
    with pytest.raises(ValueError, match="labels must be"):
        pipe.train_one_shot(codes, np.asarray([[0, 1, 2]]))
    trained = pipe.train_one_shot(codes, np.asarray([[0, 1, 0]]))
    assert trained.with_cfg(temporal_threshold=cfg.temporal_threshold).class_hvs is not None
    assert trained.with_cfg(temporal_threshold=7).class_hvs is None
    with pytest.raises(ValueError):
        trained.with_cfg(dim=512)
    with pytest.raises(ValueError, match="unknown variant"):
        HDCPipeline.init(torch.Generator(), HDCConfig(variant="sparse_bogus"),
                         device="cpu")


def test_convert_checks_fields_and_shapes():
    cfg = JConfig(dim=256, channels=4)
    fields = dataclasses.asdict(cfg)
    assert convert.config_from_fields(fields) == HDCConfig(dim=256, channels=4)
    with pytest.raises(ValueError, match="unknown config"):
        convert.config_from_fields({**fields, "mesh": 2})
    with pytest.raises(ValueError, match="do not match"):
        convert.pipeline_from_arrays(fields, np.zeros((4, 64, 7), np.uint8),
                                     np.zeros((4, 8), np.uint8), device="cpu")
    with pytest.raises(ValueError, match="come together"):
        convert.pipeline_from_arrays(fields, np.zeros((4, 64, 8), np.uint8),
                                     np.zeros((4, 8), np.uint8), device="cpu",
                                     am_counts=np.zeros((2, 256), np.int32))


# ---------------------------------------------------------------------------
# infer through the encoders' AM epilogue (encode_score_fused)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,dim,window,n_classes,tied", [
    ("sparse_compim", 1024, 32, 3, False),
    ("sparse_compim", 2048, 40, 1, False),
    ("sparse_compim", 1024, 64, 2, True),
    ("sparse_naive", 1024, 32, 3, False),
    ("dense", 2048, 32, 3, False),
    ("dense", 1024, 40, 2, True),
])
def test_fused_infer_matches_reference_pipeline(variant, dim, window, n_classes, tied):
    """``HDCPipeline.infer`` (on the CPU the fused wrappers' plain versions;
    ``sparse_naive`` its bit-domain datapath) against the reference's
    ``HDCPipeline.infer`` on a strided batch ``codes[1:]`` whose T is no
    multiple of the window: the reference runs its Pallas kernels where they
    cover every cycle (window % 32 == 0 sparse, % 16 dense; ROADMAP queue
    3) and its jnp path elsewhere.  ``tied``: every class row the same, so
    every prediction is class 0.  ``scores(encode_frames(x))``, the
    standalone AM path, gives the same scores."""
    c = 5
    pallas = window % (16 if variant == "dense" else 32) == 0
    kw = dict(dim=dim, segments=8, channels=c, window=window, variant=variant,
              n_classes=n_classes, spatial_threshold=2,
              temporal_threshold=max(1, window // 8))
    jp = JPipeline.init(jax.random.PRNGKey(dim + window),
                        JConfig(backend="pallas" if pallas else "jnp", **kw))
    rng = np.random.default_rng(dim + window + n_classes)
    codes = rng.integers(0, 64, (1, 2 * n_classes * window, c), dtype=np.uint8)
    labels = (np.arange(2 * n_classes) % n_classes)[None]
    jp = jp.train_one_shot(jnp.asarray(codes), jnp.asarray(labels))
    if tied:
        jp = dataclasses.replace(
            jp, class_hvs=jnp.broadcast_to(jp.class_hvs[:1], jp.class_hvs.shape))
    tp = _transfer(jp)
    test = rng.integers(0, 70, (3, 4 * window + 7, c), dtype=np.uint8)
    js, jpred = jp.infer(jnp.asarray(test[1:]))
    ts, tpred = tp.infer(torch.from_numpy(test)[1:])
    assert ts.shape == (2, 4, n_classes) and tpred.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
    if tied:
        assert not tpred.any()
    np.testing.assert_array_equal(
        tp.scores(tp.encode_frames(torch.from_numpy(test)[1:])).numpy(), ts.numpy())


@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
def test_infer_on_the_card_is_one_launch(monkeypatch, variant):
    """With the kernel path taken (CPU tensors stand in for the card's and
    the launches are recorded, not run), ``infer`` issues one launcher call,
    the encoder with its AM epilogue and the class rows, and no standalone
    AM launch; ``scores`` keeps the standalone AM kernel.  (``sparse_naive``
    keeps its bit-domain plain datapath for CPU codes; ``chip_smoke.py``
    counts its one kernel on the card.)"""
    from repro_torch.kernels import build
    from repro_torch.kernels.dense_hdc import ops as dense_ops
    from repro_torch.kernels.hdc_am import ops as am_ops
    from repro_torch.kernels.hdc_encoder import ops as enc_ops

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    for mod in (enc_ops, dense_ops, am_ops):
        monkeypatch.setattr(mod, "use_plain", lambda *t: False)
    monkeypatch.setattr(build, "lib", lambda: Lib())
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    for fn in (enc_ops.encoder, enc_ops.encode_score_fused, dense_ops.dense_encoder,
               dense_ops.encode_score_fused, am_ops.am_search):
        monkeypatch.setattr(fn, "launches", 0)    # restored after the test
    _, tp = _trained_pair(variant)
    codes = torch.from_numpy(np.zeros((2, 3 * 32 + 5, 4), np.uint8))
    scores, preds = tp.infer(codes)
    assert scores.shape == (2, 3, 2) and preds.shape == (2, 3)
    ((name, args),) = calls
    if variant == "dense":
        assert name == "dense_hdc_launch" and args[11] == tp.class_hvs.data_ptr()
    else:
        assert name == "hdc_encoder_launch" and args[15] == tp.class_hvs.data_ptr()
        assert args[11:13] == (0, 2) and args[3] is None   # OR mode; no frame words
    fused = enc_ops if variant != "dense" else dense_ops
    assert (fused.encode_score_fused.launches, am_ops.am_search.launches) == (1, 0)
    tp.scores(torch.zeros(5, 8, dtype=torch.int32))
    assert [c[0] for c in calls[1:]] == ["hdc_am_launch"]
    assert am_ops.am_search.launches == 1
