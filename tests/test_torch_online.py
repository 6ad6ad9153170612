"""The port's online adaptation held against the JAX package: the gated
update rules (``core/online.py``), ``HDCPipeline.fit_iterative``,
``StreamingFleet.adapt`` and ``SeizureSession.adapt``, with the reference's
trained pipelines (``backend="jnp"``) transferred through
``repro_torch.convert``.

Tolerance: exact equality.  The counter files, gates and class HVs are
integer and bit arithmetic; the two float32 steps (the margin test and the
density quantile) repeat the reference's operations in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import online as j_online
from repro.core import pipeline as j_pipeline
from repro.core.pipeline import HDCConfig as JConfig
from repro.core.pipeline import HDCPipeline as JPipeline
from repro.serve.engine import SeizureSession as JSession
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch import convert
from repro_torch.core import hv, online
from repro_torch.core import pipeline as t_pipeline
from repro_torch.serve import engine as t_engine
from repro_torch.serve.engine import SeizureSession
from repro_torch.serve.fleet import StreamingFleet

jax.config.update("jax_platform_name", "cpu")

DIM, SEGMENTS, CHANNELS, WINDOW = 256, 8, 8, 32
VARIANTS = ("sparse_compim", "sparse_naive", "dense")


def _cfg(variant: str, **overrides) -> JConfig:
    base = dict(dim=DIM, segments=SEGMENTS, channels=CHANNELS, window=WINDOW,
                variant=variant, spatial_threshold=1, temporal_threshold=4,
                backend="jnp")
    base.update(overrides)
    return JConfig(**base)


def _train_data(seed: int, frames: int = 8):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 64, (1, frames * WINDOW, CHANNELS), np.uint8)
    labels = rng.integers(0, 2, (1, frames), np.int32)
    labels[0, :2] = (0, 1)  # every class needs >= 1 example
    return codes, labels


def _jtrained(variant: str, seed: int = 0, **overrides) -> JPipeline:
    codes, labels = _train_data(seed)
    pipe = JPipeline.init(jax.random.PRNGKey(seed), _cfg(variant, **overrides))
    return pipe.train_one_shot(jnp.asarray(codes), jnp.asarray(labels))


def _transfer(jp: JPipeline):
    books = ((jp.params.item_packed, jp.params.elec_packed)
             if jp.cfg.variant == "dense" else (jp.params.item_pos, jp.params.elec_pos))
    kw = {}
    if jp.class_hvs is not None:
        kw = dict(class_hvs=np.asarray(jp.class_hvs),
                  am_counts=np.asarray(jp.am_state.counts),
                  am_n=np.asarray(jp.am_state.n))
    return convert.pipeline_from_arrays(dataclasses.asdict(jp.cfg),
                                        *map(np.asarray, books), device="cpu", **kw)


def _chunk(rng, t):
    return rng.integers(0, 64, (t, CHANNELS), np.uint8)


def _assert_state_equal(ts: online.OnlineAMState, js) -> None:
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(ts.n.numpy(), np.asarray(js.n))


# ---------------------------------------------------------------------------
# the update rules
# ---------------------------------------------------------------------------

def _update_case(seed: int, classes: int, lead: tuple):
    """A random state, frames, labels (some -1), validity and scores drawn
    from a narrow range, so ties and equal-margin scores are common."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, (*lead, classes, 40)).astype(np.int32)
    n = rng.integers(0, 2, (*lead, classes)).astype(np.int32)
    bits = rng.integers(0, 2, (*lead, 40)).astype(np.int32)
    labels = rng.integers(-1, classes, lead).astype(np.int32)
    scores = rng.integers(0, 4, (*lead, classes)).astype(np.int32)
    valid = rng.random(lead) < 0.8
    return counts, n, bits, labels, scores, valid


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("margin", [0.0, 1.0, 2.5])
def test_update_matches_reference(classes, margin):
    """One frame per state over 64 stacked states: ties in the argmax and
    the rival, margins equal to the score lead, ``-1`` labels,
    ``valid=False`` and counters that clamp at zero."""
    counts, n, bits, labels, scores, valid = _update_case(classes * 7, classes, (64,))
    jupd = jax.jit(j_online.update)
    for v in (None, valid):
        jst, japp = jupd(j_online.OnlineAMState(jnp.asarray(counts), jnp.asarray(n)),
                         jnp.asarray(bits), jnp.asarray(labels), jnp.asarray(scores),
                         margin=margin, valid=None if v is None else jnp.asarray(v))
        tst, tapp = online.update(
            online.OnlineAMState(torch.from_numpy(counts), torch.from_numpy(n)),
            torch.from_numpy(bits), torch.from_numpy(labels), torch.from_numpy(scores),
            margin=margin, valid=None if v is None else torch.from_numpy(v))
        _assert_state_equal(tst, jst)
        np.testing.assert_array_equal(tapp.numpy(), np.asarray(japp))
        assert tapp.any() and not tapp.all()
    assert (tst.counts.numpy() == 0).any() and (counts > 0).any()


@pytest.mark.parametrize("classes", [2, 3])
@pytest.mark.parametrize("margin", [0.0, 1.0])
def test_batch_update_matches_reference(classes, margin):
    """All N gated frames at once against one shared state (the reference's
    int32 einsum; the port's per-class masked sums)."""
    counts, n, bits, labels, scores, _ = _update_case(classes + 11, classes, (50,))
    state0 = (counts[0], n[0])
    jst, jgate = j_online.batch_update(
        j_online.OnlineAMState(*map(jnp.asarray, state0)), jnp.asarray(bits),
        jnp.asarray(labels), jnp.asarray(scores), margin=margin)
    tst, tgate = online.batch_update(
        online.OnlineAMState(*map(torch.from_numpy, state0)), torch.from_numpy(bits),
        torch.from_numpy(labels), torch.from_numpy(scores), margin=margin)
    _assert_state_equal(tst, jst)
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jgate))
    assert tgate.any()


def test_update_gates_and_clamps():
    """The reference's worked example: confident and correct (no update),
    wrong (add to the true class, subtract from the rival, clamp), low
    margin (gate fires), no feedback (masked)."""
    state = online.OnlineAMState(
        counts=torch.tensor([[2, 0, 1], [0, 3, 0]], dtype=torch.int32),
        n=torch.tensor([1, 1], dtype=torch.int32))
    bits = torch.tensor([1, 1, 0], dtype=torch.int32)
    label0, label_none = torch.tensor(0), torch.tensor(-1)
    st, applied = online.update(state, bits, label0, torch.tensor([5, 1]))
    assert not bool(applied) and torch.equal(st.counts, state.counts)
    st, applied = online.update(state, bits, label0, torch.tensor([1, 5]))
    assert bool(applied)
    assert st.counts.tolist() == [[3, 1, 1], [0, 2, 0]] and st.n.tolist() == [2, 0]
    _, applied = online.update(state, bits, label0, torch.tensor([5, 4]), margin=2.0)
    assert bool(applied)
    _, applied = online.update(state, bits, label_none, torch.tensor([1, 5]))
    assert not bool(applied)


def test_state_from_frames_and_rethreshold_match_reference():
    """The one-shot accumulation (labels outside [0, C) count nowhere) and
    the re-threshold with one density and with per-row densities."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (30, 64)).astype(np.uint8)
    labels = rng.integers(-1, 4, 30).astype(np.int32)
    tst = online.state_from_frames(torch.from_numpy(bits), torch.from_numpy(labels), 3)
    jst = j_online.state_from_frames(jnp.asarray(bits), jnp.asarray(labels), 3)
    _assert_state_equal(tst, jst)
    cfg = _cfg("sparse_compim", dim=64, segments=2)
    tcfg = convert.config_from_fields(dataclasses.asdict(cfg))
    dens = np.asarray([0.2, 0.35, 0.5], np.float32)
    for td, jd in ((None, None), (torch.from_numpy(dens), jnp.asarray(dens))):
        np.testing.assert_array_equal(
            hv.to_u32(online.class_hvs_from_state(tst, tcfg, density=td)),
            np.asarray(j_online.class_hvs_from_state(jst, cfg, density=jd)))


# ---------------------------------------------------------------------------
# fit_iterative
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _j_fit(cfg: JConfig, epochs: int):
    return jax.jit(functools.partial(j_pipeline._fit_iterative, cfg=cfg, epochs=epochs))


@pytest.mark.parametrize("variant", VARIANTS)
def test_fit_iterative_matches_reference(variant):
    """Class HVs, counter file and per-epoch gated-update counts after 3
    epochs at margins 0 and 1; ``epochs=0`` equals ``train_one_shot``."""
    codes, labels = _train_data(2, frames=10)
    jp = JPipeline.init(jax.random.PRNGKey(2), _cfg(variant))
    tp = _transfer(jp)
    for margin in (0.0, 1.0):
        jchvs, jstate, jn = _j_fit(jp.cfg, 3)(
            jp.params, jnp.asarray(codes), jnp.asarray(labels),
            jnp.asarray(margin, jnp.float32))
        tchvs, tstate, tn = t_pipeline._fit_iterative(
            tp.params, torch.from_numpy(codes), torch.from_numpy(labels), margin,
            tp.cfg, 3)
        np.testing.assert_array_equal(hv.to_u32(tchvs), np.asarray(jchvs))
        _assert_state_equal(tstate, jstate)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert tn.dtype == torch.int32 and tn.shape == (3,)
    fit = tp.fit_iterative(codes, labels, epochs=3, margin=1.0)
    np.testing.assert_array_equal(hv.to_u32(fit.class_hvs), np.asarray(jchvs))
    one, it0 = tp.train_one_shot(codes, labels), tp.fit_iterative(codes, labels, epochs=0)
    assert torch.equal(one.class_hvs, it0.class_hvs)
    assert torch.equal(one.am_state.counts, it0.am_state.counts)
    assert torch.equal(one.am_state.n, it0.am_state.n)


def test_fit_iterative_validation():
    codes, labels = _train_data(4)
    tp = _transfer(JPipeline.init(jax.random.PRNGKey(4), _cfg("sparse_compim")))
    with pytest.raises(ValueError, match="epochs"):
        tp.fit_iterative(codes, labels, epochs=-1)
    with pytest.raises(ValueError, match="no examples"):
        tp.fit_iterative(codes, np.zeros_like(labels), epochs=1)
    with pytest.raises(ValueError, match="labels must be in"):
        tp.fit_iterative(codes, labels + 1, epochs=1)


def test_fit_iterative_on_the_card_is_one_am_launch_an_epoch(monkeypatch):
    """With the kernel path taken (CPU tensors stand in for the card's and
    the launches are recorded, not run), ``fit_iterative`` issues one
    encoder launch and one standalone AM launch per epoch, and nothing in
    its epoch loop reads a tensor back to the host."""
    from repro_torch.kernels import build
    from repro_torch.kernels.hdc_am import ops as am_ops
    from repro_torch.kernels.hdc_encoder import ops as enc_ops

    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append(name) or 0

    for mod in (enc_ops, am_ops):
        monkeypatch.setattr(mod, "use_plain", lambda *t: False)
    monkeypatch.setattr(build, "lib", lambda: Lib())
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    for fn in (enc_ops.encoder, am_ops.am_search):
        monkeypatch.setattr(fn, "launches", 0)
    reads = []
    for name in ("item", "tolist", "numpy", "cpu"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, real=real, name=name, **k:
                            reads.append(name) or real(self, *a, **k))
    codes, labels = _train_data(6)
    tp = _transfer(JPipeline.init(jax.random.PRNGKey(6), _cfg("sparse_compim")))
    t_pipeline._fit_iterative(tp.params, torch.from_numpy(codes),
                              torch.from_numpy(labels), 0.0, tp.cfg, 4)
    assert calls == ["hdc_encoder_launch"] + ["hdc_am_launch"] * 4
    assert (enc_ops.encoder.launches, am_ops.am_search.launches) == (1, 4)
    assert reads == []


# ---------------------------------------------------------------------------
# adaptive fleets and sessions
# ---------------------------------------------------------------------------

def _banks(variant: str, **per_patient):
    jbank = {"a": _jtrained(variant, seed=0, temporal_threshold=4,
                            **per_patient.get("a", {})),
             "b": _jtrained(variant, seed=1, temporal_threshold=6,
                            **per_patient.get("b", {}))}
    return jbank, {pid: _transfer(p) for pid, p in jbank.items()}


def _assert_decisions_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.frame_index == b.frame_index and a.prediction == b.prediction
        np.testing.assert_array_equal(a.scores, np.asarray(b.scores))
        np.testing.assert_array_equal(a.frame_hv, np.asarray(b.frame_hv))


@pytest.mark.parametrize("variant", VARIANTS)
def test_fleet_adapt_matches_reference(variant):
    """Ragged schedules (zero, sub-window and longer-than-bucket chunks)
    with masked feedback and per-patient ``class_density``: applied gates,
    counter files and class rows equal the reference fleet's, and so does
    every later decision."""
    dens = {"a": {"class_density": 0.3}, "b": {"class_density": 0.6}}
    jbank, tbank = _banks(variant, **dens)
    owners = ["a", "b", "a", "b", "a"]
    jf = JFleet(jbank, owners, buckets=(8, 16, 64), backend="jnp")
    tf = StreamingFleet(tbank, owners, buckets=(8, 16, 64))
    rng = np.random.default_rng(7)
    fired = 0
    for rnd in range(6):
        lens = [0, 5, 100, 33, 64] if rnd == 0 else rng.integers(0, 90, len(owners))
        chunks = [_chunk(rng, int(t)) for t in lens]
        for g, w in zip(tf.push(chunks), jf.push(chunks)):
            _assert_decisions_equal(g, w)
        labels = np.where(rng.random(len(owners)) < 0.7,
                          rng.integers(0, 2, len(owners)), -1)
        margin = 0.0 if rnd % 2 else 3.0
        tapp = tf.adapt(labels, margin=margin)
        japp = jf.adapt(labels, margin=margin)
        np.testing.assert_array_equal(tapp, np.asarray(japp))
        fired += int(tapp.sum())
        np.testing.assert_array_equal(tf.class_rows, jf.class_rows)
        np.testing.assert_array_equal(tf.state.am_counts.numpy(), np.asarray(jf.state.am_counts))
        np.testing.assert_array_equal(tf.state.am_n.numpy(), np.asarray(jf.state.am_n))
    assert fired > 0
    tf.reset()
    jf.reset()
    np.testing.assert_array_equal(tf.class_rows, jf.class_rows)
    np.testing.assert_array_equal(tf.class_rows[0], hv.to_u32(tbank["a"].class_hvs))
    np.testing.assert_array_equal(tf.state.am_counts.numpy(), np.asarray(jf.state.am_counts))
    np.testing.assert_array_equal(tf.fill_levels, np.zeros(len(owners)))


def test_fleet_adapt_validation():
    jp = _jtrained("sparse_compim", seed=3)
    tp = _transfer(jp)
    fleet = StreamingFleet({"p": tp}, ["p", "p"])
    with pytest.raises(ValueError, match="one label per session"):
        fleet.adapt([1])
    with pytest.raises(ValueError, match="n_classes"):
        fleet.adapt([2, 0])
    # before any frame: every session is skipped
    assert not fleet.adapt([1, 1]).any()
    bare = dataclasses.replace(tp, am_state=None)
    with pytest.raises(ValueError, match="am_state"):
        StreamingFleet({"p": bare}, ["p"]).adapt([1])


@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
@pytest.mark.parametrize("piece", [256, 40])
def test_session_push_and_adapt_match_reference_and_fleet(monkeypatch, variant, piece):
    """Ragged pushes and ``adapt`` (validation, gate off, gate on) against
    the reference session and against the port's own fleet.  The fleet
    kernel's plain version counts each piece of at most ``SESSION_PIECE``
    cycles, and the host carries ``filled`` and the tail between pieces:
    at 256 a chunk is one piece, at 40 the longer chunks are split."""
    monkeypatch.setattr(t_engine, "SESSION_PIECE", piece)
    jbank, tbank = _banks(variant)
    jsess, tsess = JSession(jbank["b"]), SeizureSession(tbank["b"])
    tf = StreamingFleet(tbank, ["b"], buckets=(16, 64))
    with pytest.raises(ValueError, match="no frame emitted"):
        tsess.adapt(1)
    rng = np.random.default_rng(5)
    fired = 0
    for t in (0, 5, 27, 1, 31, 130, 64, 7, 100):
        chunk = _chunk(rng, t)
        got, want = tsess.push(chunk), jsess.push(chunk)
        _assert_decisions_equal(got, want)
        _assert_decisions_equal(got, tf.push([chunk])[0])
        assert tsess.cycles_buffered == jsess.cycles_buffered
        if got:  # the predicted label (gate off) or the other, by parity
            label = got[-1].prediction ^ (got[-1].frame_index % 2)
            applied = tsess.adapt(label)
            assert applied == jsess.adapt(label)
            assert bool(tf.adapt([label])[0]) == applied
            fired += applied
            np.testing.assert_array_equal(hv.to_u32(tsess.class_hvs),
                                          np.asarray(jsess.class_hvs))
            np.testing.assert_array_equal(tf.class_rows[0], hv.to_u32(tsess.class_hvs))
            _assert_state_equal(tsess.am_state, jsess.am_state)
    assert 0 < fired < 5
    with pytest.raises(ValueError, match="not in"):
        tsess.adapt(7)
    # the pipeline itself stays unchanged
    assert torch.equal(tbank["b"].class_hvs, SeizureSession(tbank["b"]).class_hvs)
    bare = SeizureSession(dataclasses.replace(tbank["b"], am_state=None))
    bare.push(_chunk(rng, WINDOW))
    with pytest.raises(ValueError, match="am_state"):
        bare.adapt(1)
