"""The port's fleet channel masking held against the JAX package: per-session
electrode masks carried into the fleet kernel's mask operand
(``StreamingFleet(channel_masking=True)``, ``set_channel_mask``), the
reduced-channel oracle (``dispatch.reduced_channel_config``), mask carriage
through ``reset``, checkpoints of either package and the elastic fleet's
snapshots and checkpoints.

The reference fleet applies its mask only when it also carries a fault plan
(without one, its step receives the mask in the ``fault_ber`` position and
drops it); the masked reference fleets here are therefore built with
``faults=FaultConfig()``, a plan with every target off, which the reference
documents as bit-exact with the fault-free step.

Tolerance: exact equality (integer and bit arithmetic; error messages as
text).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.reliability.faults import FaultConfig
from repro.serve import dispatch as j_dispatch
from repro.serve.fleet import StreamingFleet as JFleet
from repro.serve.lifecycle import ElasticFleet as JElastic
from repro_torch import convert
from repro_torch.kernels.hdc_fleet import ops as fleet_ops
from repro_torch.serve import dispatch
from repro_torch.serve.fleet import StreamingFleet
from repro_torch.serve.lifecycle import ElasticFleet
from test_torch_online import CHANNELS, WINDOW, _assert_decisions_equal, _chunk, _jtrained, _transfer

jax.config.update("jax_platform_name", "cpu")

# (variant, spatial_thinning): every spatial-bundle mode the mask touches
MODES = [("sparse_compim", False), ("sparse_compim", True),
         ("sparse_naive", True), ("dense", False)]
MODE_IDS = ["or", "thin", "naive", "dense"]


def _banks(variant: str, thinning: bool, n: int = 2):
    kw = dict(spatial_thinning=thinning, spatial_threshold=3) if variant != "dense" else {}
    jbank = {f"p{i}": _jtrained(variant, i, temporal_threshold=4 + i, **kw)
             for i in range(n)}
    return jbank, {pid: _transfer(p) for pid, p in jbank.items()}


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_decisions_equal(g, w)


def _random_masks(rng, s: int, dead: int) -> np.ndarray:
    mask = np.ones((s, CHANNELS), np.uint8)
    for i in range(s):
        mask[i, rng.choice(CHANNELS, dead, replace=False)] = 0
    return mask


def _schedule(rng, s: int, rounds: int = 3):
    return [[_chunk(rng, int(t)) for t in rng.integers(0, 70, s)]
            for _ in range(rounds)]


@pytest.mark.parametrize("variant,thinning", MODES, ids=MODE_IDS)
def test_all_live_mask_bit_exact_with_unmasked_fleet(variant, thinning, monkeypatch):
    """``channel_masking=True`` with every channel live changes nothing:
    decisions equal the unmasked port fleet's and the reference's.  The
    unmasked fleet hands the kernel no mask operand; the masked one hands
    it the (tile_s, channels) mask on every step."""
    jbank, tbank = _banks(variant, thinning)
    owners = ["p0", "p1", "p0"]
    ref = JFleet(jbank, owners, buckets=(16, 32), backend="jnp")
    plain = StreamingFleet(tbank, owners, buckets=(16, 32))
    masked = StreamingFleet(tbank, owners, buckets=(16, 32), channel_masking=True)
    assert masked.channel_masking and not plain.channel_masking
    seen = []
    kernel = fleet_ops.fleet_counts_kernel

    def spy(*args, chan_mask=None, **kw):
        seen.append(None if chan_mask is None else tuple(chan_mask.shape))
        return kernel(*args, chan_mask=chan_mask, **kw)

    monkeypatch.setattr(fleet_ops, "fleet_counts_kernel", spy)
    for chunks in _schedule(np.random.default_rng(9), 3):
        want = ref.push(chunks)
        seen.clear()
        _assert_streams_equal(plain.push(chunks), want)
        assert set(seen) <= {None}
        seen.clear()
        _assert_streams_equal(masked.push(chunks), want)
        assert set(seen) <= {(3, CHANNELS)}


@pytest.mark.parametrize("variant,thinning", MODES, ids=MODE_IDS)
def test_masked_fleet_matches_masked_reference(variant, thinning):
    """Random per-session masks (one to three dead electrodes), a walk to
    new masks mid-stream and an ``adapt``: decisions and state equal the
    masked reference fleet's."""
    jbank, tbank = _banks(variant, thinning)
    owners = ["p0", "p1", "p1", "p0"]
    ref = JFleet(jbank, owners, buckets=(16, 32), backend="jnp",
                 channel_masking=True, faults=FaultConfig())
    port = StreamingFleet(tbank, owners, buckets=(16, 32), channel_masking=True)
    rng = np.random.default_rng(10)
    for dead in (1, 3):
        mask = _random_masks(rng, 4, dead)
        ref.set_channel_mask(mask)
        port.set_channel_mask(mask)
        np.testing.assert_array_equal(port.channel_masks, ref.channel_masks)
        for chunks in _schedule(rng, 4, 2):
            _assert_streams_equal(port.push(chunks), ref.push(chunks))
    labels = rng.integers(-1, 2, 4)
    np.testing.assert_array_equal(port.adapt(labels), np.asarray(ref.adapt(labels)))
    for chunks in _schedule(rng, 4, 1):
        _assert_streams_equal(port.push(chunks), ref.push(chunks))
    np.testing.assert_array_equal(port.class_rows, np.asarray(ref.class_rows))


def _reduced_pipeline(jp, live: np.ndarray):
    """The port pipeline of an implant with only the ``live`` electrodes:
    the same codebook rows and class HVs, ``reduced_channel_config``."""
    tcfg = convert.config_from_fields(dataclasses.asdict(jp.cfg))
    red = dispatch.reduced_channel_config(tcfg, len(live))
    books = ((jp.params.item_packed, jp.params.elec_packed)
             if jp.cfg.variant == "dense" else (jp.params.item_pos, jp.params.elec_pos))
    return convert.pipeline_from_arrays(
        dataclasses.asdict(red), *(np.asarray(b)[live] for b in books),
        class_hvs=np.asarray(jp.class_hvs), am_counts=np.asarray(jp.am_state.counts),
        am_n=np.asarray(jp.am_state.n), device="cpu")


@pytest.mark.parametrize("variant,thinning", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("n_dead", [1, 2, 3])
def test_masked_fleet_matches_reduced_channel_oracle(variant, thinning, n_dead):
    """Each masked session of a port fleet decides as a fleet on the
    pipeline with its dead electrodes physically absent
    (``reduced_channel_config``, codebooks and codes sliced to the live
    channels); the thresholds and configs agree with the reference's."""
    jbank, tbank = _banks(variant, thinning)
    owners = ["p0", "p1", "p1"]
    rng = np.random.default_rng(11 + n_dead)
    mask = _random_masks(rng, 3, n_dead)
    port = StreamingFleet(tbank, owners, buckets=(16, 32), channel_masking=True)
    port.set_channel_mask(mask)
    oracles = []
    for i, pid in enumerate(owners):
        live = np.nonzero(mask[i])[0]
        jcfg = j_dispatch.reduced_channel_config(jbank[pid].cfg, len(live))
        red = _reduced_pipeline(jbank[pid], live)
        assert red.cfg.spatial_threshold == jcfg.spatial_threshold
        assert red.cfg.channels == jcfg.channels == len(live)
        oracles.append((StreamingFleet({pid: red}, [pid], buckets=(16, 32)), live))
    for chunks in _schedule(rng, 3):
        got = port.push(chunks)
        for i, (oracle, live) in enumerate(oracles):
            _assert_decisions_equal(got[i], oracle.push([chunks[i][:, live]])[0])
    live = np.arange(CHANNELS + 1)
    tcfg = next(iter(tbank.values())).cfg
    np.testing.assert_array_equal(
        dispatch.effective_spatial_threshold(torch.as_tensor(live), tcfg).numpy(),
        np.asarray(j_dispatch.effective_spatial_threshold(live, jbank["p0"].cfg)))


def test_set_channel_mask_validation_matches_reference():
    jbank, tbank = _banks("sparse_compim", False, n=1)
    plain_j = JFleet(jbank, ["p0", "p0"], buckets=(WINDOW,), backend="jnp")
    plain_t = StreamingFleet(tbank, ["p0", "p0"], buckets=(WINDOW,))
    ones = np.ones(CHANNELS, np.uint8)
    for fleet in (plain_j, plain_t):
        with pytest.raises(ValueError, match="channel_masking"):
            fleet.set_channel_mask(ones)
    np.testing.assert_array_equal(plain_t.channel_masks, plain_j.channel_masks)
    jf = JFleet(jbank, ["p0", "p0"], buckets=(WINDOW,), backend="jnp",
                channel_masking=True)
    tf = StreamingFleet(tbank, ["p0", "p0"], buckets=(WINDOW,), channel_masking=True)
    bad = [dict(mask=np.ones((2, CHANNELS + 1), np.uint8)),
           dict(mask=np.full(CHANNELS, 2, np.uint8)),
           dict(mask=ones, sessions=[5]), dict(mask=ones, sessions=[]),
           dict(mask=np.ones((3, CHANNELS), np.uint8), sessions=[0, 1])]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            jf.set_channel_mask(**kw)
        with pytest.raises(ValueError) as got:
            tf.set_channel_mask(**kw)
        assert str(got.value) == str(want.value)
    m = ones.copy()
    m[0] = 0
    for fleet in (jf, tf):
        fleet.set_channel_mask(m, sessions=[1])   # (C,) broadcast to one session
    np.testing.assert_array_equal(tf.channel_masks, jf.channel_masks)
    assert tf.channel_masks[1, 0] == 0 and tf.channel_masks[0, 0] == 1


def test_mask_survives_reset_and_checkpoints_of_both_packages(tmp_path):
    """Masks describe electrode health, not stream state: ``reset`` keeps
    them; each package restores the other's masked checkpoint (masks
    equal, decisions continue equal); a checkpoint without masks, of
    either package, restores as all-live."""
    jbank, tbank = _banks("sparse_compim", False, n=1)
    owners = ["p0", "p0", "p0"]
    kw = dict(buckets=(WINDOW,), channel_masking=True)
    jf = JFleet(jbank, owners, backend="jnp", faults=FaultConfig(), **kw)
    tf = StreamingFleet(tbank, owners, **kw)
    mask = np.ones((3, CHANNELS), np.uint8)
    mask[0, 3] = mask[2, [1, 6]] = 0
    rng = np.random.default_rng(13)
    chunks = [_chunk(rng, WINDOW + 5) for _ in range(3)]
    for f in (jf, tf):
        f.set_channel_mask(mask)
    before = tf.push(chunks)
    _assert_streams_equal(before, jf.push(chunks))
    tf.reset()
    np.testing.assert_array_equal(tf.channel_masks, mask)
    _assert_streams_equal(tf.push(chunks), before)      # same mask, same decisions

    tf.save(str(tmp_path / "port"))
    jf.reset()
    jf.push(chunks)
    jf.save(str(tmp_path / "ref"))
    j_resumed = JFleet(jbank, owners, backend="jnp", faults=FaultConfig(), **kw)
    j_resumed.restore(str(tmp_path / "port"))
    t_resumed = StreamingFleet(tbank, owners, **kw)
    t_resumed.restore(str(tmp_path / "ref"))
    for resumed in (j_resumed, t_resumed):
        np.testing.assert_array_equal(resumed.channel_masks, mask)
    nxt = [_chunk(rng, WINDOW) for _ in range(3)]
    want = jf.push(nxt)
    _assert_streams_equal(t_resumed.push(nxt), want)
    _assert_streams_equal(tf.push(nxt), j_resumed.push(nxt))

    plain_t = StreamingFleet(tbank, owners, buckets=(WINDOW,))
    plain_t.push(chunks)
    plain_t.save(str(tmp_path / "plain_port"))
    plain_j = JFleet(jbank, owners, buckets=(WINDOW,), backend="jnp")
    plain_j.push(chunks)
    plain_j.save(str(tmp_path / "plain_ref"))
    for root in ("plain_port", "plain_ref"):
        tf.restore(str(tmp_path / root))
        np.testing.assert_array_equal(tf.channel_masks, np.ones((3, CHANNELS), np.uint8))


def test_elastic_mask_follows_the_session(tmp_path):
    """Quarantine follows the session through evict and readmit as in the
    reference (the snapshot carries it, a fresh admission starts all-live)
    and through either package's elastic checkpoint.  The reference
    elastic fleet drops its masks, so a masked session's decisions (before
    eviction, after readmission from its snapshot and after
    ``from_checkpoint``) are held against a masked one-session reference
    fleet with an all-off fault plan; the others equal the reference
    elastic fleet's."""
    jbank, tbank = _banks("sparse_compim", False)
    kw = dict(tile=4, max_tiles=2, buckets=(WINDOW,), channel_masking=True)
    jf, tf = JElastic(jbank, backend="jnp", **kw), ElasticFleet(tbank, **kw)
    sid = tf.admit("p0")
    other = tf.admit("p1")
    assert (sid, other) == (jf.admit("p0"), jf.admit("p1"))
    m = np.ones(CHANNELS, np.uint8)
    m[2] = 0
    for f in (jf, tf):
        f.set_channel_mask(m, sessions=[f.slot_of(sid)])
    np.testing.assert_array_equal(tf.channel_masks, jf.channel_masks)
    single = JFleet({"p0": jbank["p0"]}, ["p0"], buckets=(WINDOW,), backend="jnp",
                    channel_masking=True, faults=FaultConfig())
    single.set_channel_mask(m)
    rng = np.random.default_rng(15)
    for _ in range(2):
        chunks = {sid: _chunk(rng, WINDOW + 9), other: _chunk(rng, WINDOW)}
        got, want = tf.push_sessions(chunks), jf.push_sessions(chunks)
        _assert_decisions_equal(got[other], want[other])
        _assert_decisions_equal(got[sid], single.push([chunks[sid]])[0])

    slot0 = tf.slot_of(sid)
    snap, jsnap = tf.evict([sid])[sid], jf.evict([sid])[sid]
    np.testing.assert_array_equal(snap.channel_mask, m)
    np.testing.assert_array_equal(snap.channel_mask, jsnap.channel_mask)
    sid2 = tf.admit("p1")                         # fresh: all-live, same slot
    assert sid2 == jf.admit("p1") and tf.slot_of(sid2) == slot0
    np.testing.assert_array_equal(tf.channel_masks[tf.slot_of(sid2)], np.ones(CHANNELS))
    sid3 = tf.admit("p0", snapshot=snap)          # reconnect: the mask returns
    assert sid3 == jf.admit("p0", snapshot=jsnap)
    np.testing.assert_array_equal(tf.channel_masks[tf.slot_of(sid3)], m)
    np.testing.assert_array_equal(tf.channel_masks, jf.channel_masks)
    chunk = _chunk(rng, WINDOW + 3)
    _assert_decisions_equal(tf.push_sessions({sid3: chunk})[sid3],
                            single.push([chunk])[0])
    jf.push_sessions({sid3: chunk})

    tf.save(str(tmp_path / "port"))
    jf.save(str(tmp_path / "ref"))
    restored = [JElastic.from_checkpoint(jbank, str(tmp_path / "port"), backend="jnp",
                                         warm=False, **kw),
                ElasticFleet.from_checkpoint(tbank, str(tmp_path / "ref"), **kw),
                ElasticFleet.from_checkpoint(tbank, str(tmp_path / "port"), **kw)]
    for f in restored:
        np.testing.assert_array_equal(f.channel_masks, tf.channel_masks)
    # the masked session's state is the port's own (the reference's step
    # ran it unmasked), so the decisions continue from the port's checkpoint
    chunk = _chunk(rng, WINDOW)
    want = single.push([chunk])[0]
    _assert_decisions_equal(restored[2].push_sessions({sid3: chunk})[sid3], want)
    _assert_decisions_equal(tf.push_sessions({sid3: chunk})[sid3], want)
