"""The port's electrode-fault models and channel-health monitors held
against the JAX package: ``reliability/channels.py`` (a numpy copy: the
same seeds give the same signals, codes, masks, statistics and event logs),
and monitor masks driving the port's masked fleet against the reference's
masked fleet.  The sweep is in ``tests/test_torch_sweep.py``.

The reference fleet applies a channel mask only when it also carries a
fault plan, so its masked fleets here are built with ``faults=FaultConfig()``
(every target off, documented as bit-exact with the fault-free step).

Tolerance: exact equality.  The fault models and statistics are the same
numpy operations on the same inputs; the fleets are integer and bit
arithmetic.
"""

import jax
import numpy as np
import pytest

from repro.data import ieeg as j_ieeg
from repro.reliability import channels as j_chan
from repro.reliability.faults import FaultConfig as JFaultConfig
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.data import ieeg
from repro_torch.reliability import channels as chan
from repro_torch.serve.fleet import StreamingFleet
from test_torch_online import CHANNELS, _assert_decisions_equal, _jtrained, _transfer

jax.config.update("jax_platform_name", "cpu")

SHORT = dict(pre_s=1.0, ictal_s=1.0, post_s=0.5)   # 1280-sample records


def _raises_alike(fn_t, fn_j, *args, **kw):
    with pytest.raises(ValueError) as a:
        fn_t(*args, **kw)
    with pytest.raises(ValueError) as b:
        fn_j(*args, **kw)
    assert str(a.value) == str(b.value)


# ---------------------------------------------------------------------------
# fault models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", chan.CHANNEL_FAULT_TYPES)
def test_signal_fault_matches_reference(kind):
    x = np.random.default_rng(0).standard_normal((CHANNELS, 3000)).astype(np.float32)
    for ch, start in ((0, 0), (5, 1234)):
        got = chan.inject_signal_fault(x, ch, kind, np.random.default_rng(1), start=start)
        want = j_chan.inject_signal_fault(x, ch, kind, np.random.default_rng(1), start=start)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert chan.CHANNEL_FAULT_TYPES == j_chan.CHANNEL_FAULT_TYPES
    assert chan.CODE_FAULT_TYPES == j_chan.CODE_FAULT_TYPES
    _raises_alike(chan.inject_signal_fault, j_chan.inject_signal_fault, x, 0, kind,
                  np.random.default_rng(1), start=3000)


def test_signal_fault_transform_through_make_record():
    """Faults injected through ``make_record``'s hook: the records' codes
    and labels equal the reference's."""
    faults = [(1, "dead"), (3, "line_noise"), (6, "dropout")]
    got = ieeg.make_record(np.random.default_rng(4), channels=CHANNELS,
                           signal_transform=chan.signal_fault_transform(faults, start=200),
                           **SHORT)
    want = j_ieeg.make_record(np.random.default_rng(4), channels=CHANNELS,
                              signal_transform=j_chan.signal_fault_transform(faults, start=200),
                              **SHORT)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.label, want.label)
    assert (got.codes[200:, 1] == 0).all()
    _raises_alike(chan.signal_fault_transform, j_chan.signal_fault_transform, [(0, "fire")])


@pytest.mark.parametrize("kind", chan.CODE_FAULT_TYPES)
def test_code_fault_and_degrade_batch_match_reference(kind):
    codes = np.random.default_rng(2).integers(0, 64, (3, 700, CHANNELS), np.uint8)
    got = chan.inject_code_fault(codes, 4, kind, np.random.default_rng(3), start=50)
    want = j_chan.inject_code_fault(codes, 4, kind, np.random.default_rng(3), start=50)
    np.testing.assert_array_equal(got, want)
    for n_failed in (0, 2, CHANNELS):
        gb, gm = chan.degrade_batch(codes, n_failed, kind, seed=7)
        wb, wm = j_chan.degrade_batch(codes, n_failed, kind, seed=7)
        np.testing.assert_array_equal(gb, wb)
        np.testing.assert_array_equal(gm, wm)
        assert gm.dtype == np.uint8 and (gm.sum(1) == CHANNELS - n_failed).all()
    _raises_alike(chan.inject_code_fault, j_chan.inject_code_fault, codes, 0,
                  "gain_drift", np.random.default_rng(0))
    _raises_alike(chan.degrade_batch, j_chan.degrade_batch, codes, CHANNELS + 1, kind)


def test_channel_stats_match_reference():
    rng = np.random.default_rng(5)
    blocks = [rng.integers(0, 64, (256, CHANNELS), np.uint8),
              chan.degrade_batch(rng.integers(0, 64, (1, 256, CHANNELS), np.uint8),
                                 3, "saturated", seed=1)[0][0],
              np.zeros((40, CHANNELS), np.uint8), np.full((1, CHANNELS), 9, np.uint8)]
    for b in blocks:
        for got, want in zip(chan.channel_stats(b), j_chan.channel_stats(b)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# monitors
# ---------------------------------------------------------------------------

def _health_schedule(seed: int, sessions: int, blocks: int):
    """Per block an (S, 256, C) code batch: healthy, then two dead channels
    per session for four blocks, then healthy again (reinstatement), with
    a saturated channel and an empty block on the way."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(blocks):
        batch = rng.integers(0, 64, (sessions, 256, CHANNELS), np.uint8)
        if 2 <= b < 6:
            batch, _ = chan.degrade_batch(batch, 2, "dead", seed=seed)
        if b == 3:
            batch, _ = chan.degrade_batch(batch, 1, "saturated", seed=seed + 1)
        out.append(batch[:, :0] if b == 7 else batch)
    return out


def test_monitors_match_reference():
    """Masks after every block and the event logs (quarantine, reinstate,
    their statistics) equal the reference's, per session and merged."""
    kw = dict(quarantine_after=2, reinstate_after=3)
    t_fleet, j_fleet = chan.FleetChannelMonitor(3, CHANNELS, **kw), \
        j_chan.FleetChannelMonitor(3, CHANNELS, **kw)
    t_one, j_one = chan.ChannelHealthMonitor(CHANNELS), j_chan.ChannelHealthMonitor(CHANNELS)
    for batch in _health_schedule(0, 3, 12):
        np.testing.assert_array_equal(t_fleet.observe(batch), j_fleet.observe(batch))
        np.testing.assert_array_equal(t_one.observe(batch[0]), j_one.observe(batch[0]))
    np.testing.assert_array_equal(t_fleet.masks, j_fleet.masks)
    assert t_fleet.events == j_fleet.events and t_one.events == j_one.events
    assert {e["event"] for e in t_fleet.events} == {"quarantine", "reinstate"}
    assert t_fleet.n_quarantined == j_fleet.n_quarantined
    assert t_one.n_quarantined == j_one.n_quarantined
    _raises_alike(lambda: chan.ChannelHealthMonitor(4).observe(np.zeros((9, 5), np.uint8)),
                  lambda: j_chan.ChannelHealthMonitor(4).observe(np.zeros((9, 5), np.uint8)))
    _raises_alike(lambda: chan.FleetChannelMonitor(2, 4).observe(np.zeros((3, 9, 4))),
                  lambda: j_chan.FleetChannelMonitor(2, 4).observe(np.zeros((3, 9, 4))))


@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
def test_monitor_masks_drive_masked_fleet_as_reference(variant):
    """Streams that lose two electrodes a session: each round the monitor
    observes the round's codes and changed masks go to ``set_channel_mask``
    of the port's masked fleet and the reference's (built with an empty
    fault plan); masks and decisions equal round for round, and once
    quarantined the masks equal ``degrade_batch``'s."""
    jbank = {f"p{i}": _jtrained(variant, i, temporal_threshold=4 + i) for i in range(2)}
    owners = ["p0", "p1", "p1", "p0"]
    ref = JFleet(jbank, owners, buckets=(64,), backend="jnp", channel_masking=True,
                 faults=JFaultConfig())
    port = StreamingFleet({k: _transfer(v) for k, v in jbank.items()}, owners,
                          buckets=(64,), channel_masking=True)
    t_mon, j_mon = chan.FleetChannelMonitor(4, CHANNELS, max_stuck=40), \
        j_chan.FleetChannelMonitor(4, CHANNELS, max_stuck=40)
    rng = np.random.default_rng(8)
    streams = rng.integers(0, 64, (4, 6 * 64, CHANNELS), np.uint8)
    bad, live = chan.degrade_batch(streams[:, 64:], 2, "dead", seed=3)
    streams[:, 64:] = bad
    changed = 0
    for r in range(6):
        batch = streams[:, r * 64:(r + 1) * 64]
        m = t_mon.observe(batch)
        np.testing.assert_array_equal(m, j_mon.observe(batch))
        if not np.array_equal(m, port.channel_masks):
            port.set_channel_mask(m)
            ref.set_channel_mask(m)
            changed += 1
        for g, w in zip(port.push_codes(batch), ref.push_codes(batch)):
            _assert_decisions_equal(g, w)
    assert changed >= 1
    np.testing.assert_array_equal(port.channel_masks, live)
    np.testing.assert_array_equal(ref.channel_masks, live)
