"""The port's batched engine, streaming-session snapshots and fleet
checkpoints held against the JAX package (``backend="jnp"`` pipelines
transferred through ``repro_torch.convert``), and the slice as a whole:
``fit_iterative`` -> an adaptive fleet -> ``save``/``restore`` -> a session
resumed from a reference snapshot.

Tolerance: exact equality.  Frames, scores, counter files and saved arrays
are integer and bit arithmetic; snapshots are compared as arrays, since
two ``.npz`` blobs of equal arrays may differ in their zip bytes.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as j_ckpt
from repro.core.pipeline import HDCPipeline as JPipeline
from repro.serve.engine import SeizureSession as JSession
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.engine import SessionSnapshot as JSnapshot
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import hv
from repro_torch.serve import engine as t_engine
from repro_torch.serve.engine import SeizureSession, ServingEngine, SessionSnapshot
from repro_torch.serve.fleet import FleetState, StreamingFleet
from test_torch_online import (CHANNELS, DIM, WINDOW, _assert_decisions_equal, _cfg,
                               _chunk, _jtrained, _train_data, _transfer)

jax.config.update("jax_platform_name", "cpu")

SNAPSHOT_ARRAYS = ("counts", "class_rows", "am_counts", "am_n", "last_frame",
                   "last_scores")
SNAPSHOT_SCALARS = ("patient_id", "filled", "frame_index", "has_frame")


def _banks(variant: str = "sparse_compim", **cfg_kw):
    jbank = {"a": _jtrained(variant, 0, temporal_threshold=4, **cfg_kw),
             "b": _jtrained(variant, 1, temporal_threshold=6, **cfg_kw),
             "c": _jtrained(variant, 2, temporal_threshold=5, **cfg_kw)}
    return jbank, {pid: _transfer(p) for pid, p in jbank.items()}


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_decisions_equal(g, w)


def _assert_snapshots_equal(a, b):
    for f in SNAPSHOT_SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    for f in SNAPSHOT_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the batched engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["sparse_compim", "sparse_naive", "dense"])
def test_engine_serve_matches_reference(variant):
    """Mixed-patient batches that need padding (1 -> 1, 3 -> 4, 5 -> 8) at
    a length with a partial last window: decisions equal the reference
    engine's and each pipeline's own ``infer`` and ``encode_frames``.  Each
    (request, frame) is one session of the fleet kernel's plain version."""
    jbank, tbank = _banks(variant)
    jeng, teng = JEngine(jbank), ServingEngine(tbank)
    assert teng.patient_ids == jeng.patient_ids and teng.device.type == "cpu"
    rng = np.random.default_rng(4)
    for pids in (["a"], ["b", "a", "c"], ["c", "c", "a", "b", "a"]):
        reqs = [(pid, _chunk(rng, 3 * WINDOW + 5)) for pid in pids]
        got, want = teng.serve(reqs), jeng.serve(reqs)
        for g, w, (pid, codes) in zip(got, want, reqs):
            assert (g.request_id, g.patient_id) == (w.request_id, w.patient_id)
            np.testing.assert_array_equal(g.scores, np.asarray(w.scores))
            np.testing.assert_array_equal(g.predictions, np.asarray(w.predictions))
            np.testing.assert_array_equal(g.frames, np.asarray(w.frames))
            assert g.frames.dtype == np.uint32 and g.frames.shape == (3, DIM // 32)
            s, p = tbank[pid].infer(codes[None])
            np.testing.assert_array_equal(g.scores, s[0].numpy())
            np.testing.assert_array_equal(g.predictions, p[0].numpy())
            np.testing.assert_array_equal(
                g.frames, hv.to_u32(tbank[pid].encode_frames(codes[None]))[0])
    assert teng.serve([]) == []


def test_engine_errors_match_reference():
    """Each bad batch or bank raises in the port as in the reference."""
    jbank, tbank = _banks()
    zeros = np.zeros((2 * WINDOW, CHANNELS), np.uint8)
    bad = [(KeyError, "unknown patient", [("nobody", zeros)]),
           (ValueError, "shape", [("a", zeros), ("b", zeros[:WINDOW])]),
           (ValueError, "SeizureSession", [("a", zeros[:WINDOW - 1])])]
    for eng in (ServingEngine(tbank), JEngine(jbank)):
        for exc, match, reqs in bad:
            with pytest.raises(exc, match=match):
                eng.serve(reqs)
    for engine_cls, bank in ((ServingEngine, tbank), (JEngine, jbank)):
        with pytest.raises(ValueError, match="untrained"):
            engine_cls({"p": dataclasses.replace(bank["a"], class_hvs=None)})
        with pytest.raises(ValueError, match="at least one pipeline"):
            engine_cls({})


def test_engine_on_the_card_is_one_fleet_launch(monkeypatch):
    """With the kernel path taken (CPU tensors stand in for the card's and
    the launches are recorded, not run), one ``serve`` of 3 requests of 2
    frames issues one fleet-kernel launch of 4 x 2 frame-sessions."""
    from repro_torch.kernels import build
    from repro_torch.kernels.hdc_fleet import ops as fleet_ops

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(fleet_ops, "use_plain", lambda *t: False)
    monkeypatch.setattr(build, "lib", lambda: Lib())
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fleet_ops.fleet_counts_kernel, "launches", 0)
    _, tbank = _banks()
    rng = np.random.default_rng(1)
    out = ServingEngine(tbank).serve([(pid, _chunk(rng, 2 * WINDOW)) for pid in "abc"])
    assert len(out) == 3 and out[0].frames.shape == (2, DIM // 32)
    ((name, args),) = calls
    assert name == "hdc_fleet_launch" and args[7:9] == (8, WINDOW)  # S, T32
    assert fleet_ops.fleet_counts_kernel.launches == 1


# ---------------------------------------------------------------------------
# session snapshots across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
def test_snapshots_cross_both_ways(variant):
    """A snapshot taken mid-window after an ``adapt`` in one package
    resumes in the other through ``to_bytes``/``from_bytes``: the
    snapshots are equal as arrays, and so is every later decision and
    adapt.  Blobs without ``channel_mask`` load; one with it keeps it."""
    jbank, tbank = _banks(variant)
    rng = np.random.default_rng(9)
    lead = [_chunk(rng, t) for t in (40, 70, 13)]
    tail = [_chunk(rng, t) for t in (5, 90, 33)]
    jsess, tsess = JSession(jbank["c"]), SeizureSession(tbank["c"])
    for chunk in lead:
        _assert_decisions_equal(tsess.push(chunk), jsess.push(chunk))
    label = 1 - jsess._last.prediction
    assert tsess.adapt(label) is jsess.adapt(label) is True
    jsnap, tsnap = jsess.snapshot("c"), tsess.snapshot("c")
    _assert_snapshots_equal(tsnap, jsnap)
    assert 0 < tsnap.filled < WINDOW and tsnap.has_frame == 1

    from_ref = SessionSnapshot.from_bytes(jsnap.to_bytes())     # JAX -> port
    from_port = JSnapshot.from_bytes(tsnap.to_bytes())          # port -> JAX
    _assert_snapshots_equal(from_ref, jsnap)
    _assert_snapshots_equal(from_port, tsnap)
    assert from_ref.channel_mask is None and from_port.channel_mask is None
    t_resumed = SeizureSession.from_snapshot(tbank["c"], from_ref)
    j_resumed = JSession.from_snapshot(jbank["c"], from_port)
    for chunk in tail:
        want = jsess.push(chunk)
        _assert_decisions_equal(t_resumed.push(chunk), want)
        _assert_decisions_equal(j_resumed.push(chunk), want)
    assert t_resumed.adapt(0) == jsess.adapt(0) == j_resumed.adapt(0)
    _assert_snapshots_equal(t_resumed.snapshot("c"), jsess.snapshot("c"))

    masked = dataclasses.replace(tsnap, channel_mask=np.ones(CHANNELS, np.uint8))
    back = JSnapshot.from_bytes(masked.to_bytes())
    np.testing.assert_array_equal(back.channel_mask, masked.channel_mask)
    fresh = SeizureSession(tbank["a"]).snapshot()
    _assert_snapshots_equal(fresh, JSession(jbank["a"]).snapshot())
    assert SessionSnapshot.from_bytes(fresh.to_bytes()).am_counts is not None


def test_session_push_validation():
    _, tbank = _banks()
    sess = SeizureSession(tbank["a"])
    with pytest.raises(ValueError, match="code chunk"):
        sess.push(np.zeros((4, CHANNELS + 1), np.uint8))
    with pytest.raises(ValueError, match="integer"):
        sess.push(np.zeros((4, CHANNELS), np.float32))
    with pytest.raises(ValueError, match="alphabet"):
        sess.push(np.full((4, CHANNELS), 64, np.int32))
    with pytest.raises(ValueError, match="trained"):
        SeizureSession(dataclasses.replace(tbank["a"], class_hvs=None))
    assert sess.push(np.zeros((0, CHANNELS), np.uint8)) == []
    assert sess.push(torch.zeros((WINDOW, CHANNELS), dtype=torch.int64))[0].frame_index == 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _schedules(rng, n_sessions: int, rounds: int):
    return [[_chunk(rng, int(t)) for t in rng.integers(0, 50, n_sessions)]
            for _ in range(rounds)]


@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
def test_fleet_checkpoint_resumes_mid_stream_like_reference(tmp_path, variant):
    """The reference's mid-stream test, held against the reference: both
    fleets advance and adapt; the port saves, a fresh port fleet restores
    and continues equal to the reference's uninterrupted fleet.  The
    saved files have the reference's layout: the same leaf keys, shapes,
    dtypes and arrays, and the same manifest meta."""
    jbank, tbank = _banks(variant)
    owners = ["a", "b", "a"]
    rng = np.random.default_rng(11)
    jf = JFleet(jbank, owners, buckets=(8, 32), backend="jnp")
    tf = StreamingFleet(tbank, owners, buckets=(8, 32))
    for chunks in _schedules(rng, 3, 3):
        _assert_streams_equal(tf.push(chunks), jf.push(chunks))
        labels = rng.integers(-1, 2, 3)
        np.testing.assert_array_equal(tf.adapt(labels), np.asarray(jf.adapt(labels)))
    path = tf.save(str(tmp_path / "port"))
    assert path.endswith("step_00000000")
    j_ckpt.save(str(tmp_path / "ref"), 0, jf.state)
    saved = [json.load(open(tmp_path / d / "step_00000000" / "manifest.json"))["leaves"]
             for d in ("port", "ref")]
    assert saved[0] == saved[1]
    assert tf._meta() == jf._meta()  # the bank fingerprint hashes the same bytes
    assert [leaf["key"] for leaf in saved[0]] == [f.name for f in dataclasses.fields(FleetState)]
    for leaf in saved[0]:
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / "step_00000000" / leaf["file"]),
            np.load(tmp_path / "ref" / "step_00000000" / leaf["file"]))
    assert tf.save(str(tmp_path / "port")).endswith("step_00000001")

    sched = _schedules(rng, 3, 3)
    want = [jf.push(chunks) for chunks in sched]
    fresh = StreamingFleet(tbank, owners, buckets=(8, 32))
    assert fresh.restore(str(tmp_path / "port"), step=0) == 0
    np.testing.assert_array_equal(fresh.fill_levels, tf.fill_levels)
    np.testing.assert_array_equal(fresh.class_rows, tf.class_rows)
    for chunks, w in zip(sched, want):
        _assert_streams_equal(fresh.push(chunks), w)


def test_fleet_checkpoint_refuses_other_geometry_and_banks(tmp_path):
    _, tbank = _banks()
    fleet = StreamingFleet({"p": tbank["a"]}, ["p"])
    fleet.save(str(tmp_path))
    with pytest.raises(ValueError, match="does not match"):
        StreamingFleet({"p": tbank["a"]}, ["p", "p"]).restore(str(tmp_path))
    with pytest.raises(ValueError, match="does not match"):
        StreamingFleet({"p": tbank["b"]}, ["p"]).restore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        fleet.restore(str(tmp_path / "empty"))
    assert StreamingFleet({"p": tbank["a"]}, ["p"]).restore(str(tmp_path)) == 0


@dataclasses.dataclass(frozen=True)
class _Pair:
    words: torch.Tensor
    extra: dict


def test_checkpoint_module(tmp_path):
    """Trees of dataclasses, dicts, lists and None; the atomic layout (a
    leftover ``.tmp`` is ignored, as is a step without a manifest); 32-bit
    words across signedness; shape and dtype refusals; ``link_from``;
    ``restore_latest``; the async writer and its garbage collection."""
    root = str(tmp_path)
    words = torch.tensor([[-1, 7], [3, -(2 ** 31)]], dtype=torch.int32)
    tree = _Pair(words=words, extra={"z": np.arange(3.0), "a": [torch.ones(2), None]})
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008")
    assert ckpt.latest_step(root) is None and ckpt.restore_latest(root, tree) == (None, None)
    ckpt.save(root, 3, tree, meta={"m": 1})
    manifest = json.load(open(tmp_path / "step_00000003" / "manifest.json"))
    assert [leaf["key"] for leaf in manifest["leaves"]] == ["words", "extra/a/0", "extra/z"]
    assert manifest["meta"] == {"m": 1} and ckpt.latest_step(root) == 3
    step, back = ckpt.restore_latest(root, tree)
    assert step == 3 and torch.equal(back.words, words) and back.extra["a"][1] is None
    np.testing.assert_array_equal(back.extra["z"], np.arange(3.0))

    u32 = _Pair(words=hv.to_u32(words), extra={})
    ckpt.save(root, 4, u32)
    np.testing.assert_array_equal(np.load(ckpt.leaf_files(root, 4)["words"]),
                                  hv.to_u32(words))
    assert torch.equal(ckpt.restore(root, 4, _Pair(words=words, extra={})).words, words)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(root, 4, _Pair(words=words[:1], extra={}))
    with pytest.raises(ValueError, match="dtype mismatch"):
        ckpt.restore(root, 4, _Pair(words=words.to(torch.float32), extra={}))

    ckpt.save(root, 5, tree, link_from={"words": ckpt.leaf_files(root, 3)["words"]})
    assert torch.equal(ckpt.restore(root, 5, tree).words, words)
    with pytest.raises(ValueError, match="link_from"):
        ckpt.save(root, 6, u32, link_from={"words": ckpt.leaf_files(root, 3)["words"]})

    writer = ckpt.AsyncCheckpointer(str(tmp_path / "async"), keep=2)
    for s in range(4):
        writer.save_async(s, _Pair(words=words + s, extra={}))
    writer.wait()
    assert ckpt.list_steps(str(tmp_path / "async")) == [2, 3]
    like = _Pair(words=words, extra={})
    assert torch.equal(ckpt.restore(str(tmp_path / "async"), 3, like).words, words + 3)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_slice_fit_adapt_checkpoint_and_resume_match_reference(tmp_path):
    """``fit_iterative`` on each patient -> an adaptive fleet over the
    retrained bank -> ``save`` and ``restore`` mid-stream into a fresh
    fleet -> a session resumed from a reference snapshot, each step equal
    to the reference."""
    jbank, tbank = {}, {}
    for i, pid in enumerate("ab"):
        codes, labels = _train_data(20 + i, frames=10)
        jp = JPipeline.init(jax.random.PRNGKey(20 + i), _cfg("sparse_compim",
                                                             temporal_threshold=4 + i))
        tp = _transfer(jp)
        jbank[pid] = jp.fit_iterative(jnp.asarray(codes), jnp.asarray(labels),
                                      epochs=3, margin=1.0)
        tbank[pid] = tp.fit_iterative(codes, labels, epochs=3, margin=1.0)
        np.testing.assert_array_equal(hv.to_u32(tbank[pid].class_hvs),
                                      np.asarray(jbank[pid].class_hvs))
    owners = ["a", "b", "b", "a"]
    jf = JFleet(jbank, owners, buckets=(16, 64), backend="jnp")
    tf = StreamingFleet(tbank, owners, buckets=(16, 64))
    rng = np.random.default_rng(21)
    for chunks in _schedules(rng, 4, 4):
        out = jf.push(chunks)
        _assert_streams_equal(tf.push(chunks), out)
        labels = np.where([len(o) > 0 for o in out], rng.integers(0, 2, 4), -1)
        np.testing.assert_array_equal(tf.adapt(labels), np.asarray(jf.adapt(labels)))
    tf.save(str(tmp_path))
    resumed = StreamingFleet(tbank, owners, buckets=(16, 64))
    resumed.restore(str(tmp_path))
    for chunks in _schedules(rng, 4, 2):
        _assert_streams_equal(resumed.push(chunks), jf.push(chunks))

    jsess = JSession(jbank["b"])
    for t in (50, 20):
        jsess.push(_chunk(rng, t))
    jsess.adapt(1)
    tsess = SeizureSession.from_snapshot(
        tbank["b"], SessionSnapshot.from_bytes(jsess.snapshot("b").to_bytes()))
    for t in (12, 77):
        chunk = _chunk(rng, t)
        _assert_decisions_equal(tsess.push(chunk), jsess.push(chunk))
    np.testing.assert_array_equal(hv.to_u32(tsess.class_hvs), np.asarray(jsess.class_hvs))
