"""The port's streaming fleet and its dispatch helpers held against the JAX
package's ``StreamingFleet(backend="jnp")`` and ``repro.serve.dispatch``,
with the trained per-patient pipelines transferred through
``repro_torch.convert``.

Tolerance: exact equality.  The fleet datapath is integer and bit
arithmetic throughout, so decisions (frame index, scores, prediction,
frame HV), fill levels and the device state must agree bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import HDCConfig as JConfig
from repro.core.pipeline import HDCPipeline as JPipeline
from repro.serve import dispatch as j_dispatch
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch import convert
from repro_torch.core import hv
from repro_torch.serve import dispatch
from repro_torch.serve.fleet import StreamingFleet

jax.config.update("jax_platform_name", "cpu")

DIM, SEGMENTS, WINDOW = 256, 8, 32


def _jit(fn, **static):
    """A reference function compiled once with its static arguments bound:
    the same integer operations, without the op-by-op dispatch that would
    dominate these tests' time."""
    return jax.jit(functools.partial(fn, **static))


def _jtrained(seed: int, channels: int, threshold: int,
              **cfg_kw) -> JPipeline:
    rng = np.random.default_rng(seed)
    cfg = JConfig(dim=DIM, segments=SEGMENTS, channels=channels, window=WINDOW,
                  temporal_threshold=threshold, backend="jnp", **cfg_kw)
    codes = rng.integers(0, 64, (2, 4 * WINDOW, channels), np.uint8)
    labels = rng.integers(0, 2, (2, 4), np.int32)
    labels[0, :2] = (0, 1)
    return JPipeline.init(jax.random.PRNGKey(seed), cfg).train_one_shot(
        jnp.asarray(codes), jnp.asarray(labels))


def _transfer(jp: JPipeline):
    if jp.cfg.variant == "dense":
        books = jp.params.item_packed, jp.params.elec_packed
    else:
        books = jp.params.item_pos, jp.params.elec_pos
    return convert.pipeline_from_arrays(
        dataclasses.asdict(jp.cfg), *map(np.asarray, books),
        class_hvs=np.asarray(jp.class_hvs),
        am_counts=np.asarray(jp.am_state.counts),
        am_n=np.asarray(jp.am_state.n), device="cpu")


def _banks(channels: int, **cfg_kw):
    jbank = {"a": _jtrained(0, channels, 4, **cfg_kw),
             "b": _jtrained(1, channels, 6, **cfg_kw),
             "c": _jtrained(2, channels, 5, **cfg_kw)}
    return jbank, {pid: _transfer(p) for pid, p in jbank.items()}


def _assert_decisions_equal(got, want):
    assert len(got) == len(want)
    for sg, sw in zip(got, want):
        assert len(sg) == len(sw)
        for a, b in zip(sg, sw):
            assert a.frame_index == b.frame_index
            assert a.prediction == b.prediction
            np.testing.assert_array_equal(a.scores, np.asarray(b.scores))
            np.testing.assert_array_equal(a.frame_hv, np.asarray(b.frame_hv))


def _assert_state_equal(tf: StreamingFleet, jf: JFleet):
    ts, js = tf.state, jf.state
    np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
    np.testing.assert_array_equal(ts.filled.numpy(), np.asarray(js.filled))
    np.testing.assert_array_equal(ts.frame_index.numpy(),
                                  np.asarray(js.frame_index))
    np.testing.assert_array_equal(hv.to_u32(ts.class_rows),
                                  np.asarray(js.class_rows))
    np.testing.assert_array_equal(hv.to_u32(ts.last_frame),
                                  np.asarray(js.last_frame))
    np.testing.assert_array_equal(ts.last_scores.numpy(),
                                  np.asarray(js.last_scores))
    np.testing.assert_array_equal(ts.has_frame.numpy(), np.asarray(js.has_frame))
    np.testing.assert_array_equal(tf.fill_levels, jf.fill_levels)
    np.testing.assert_array_equal(tf.frame_indices, jf.frame_indices)


# ---------------------------------------------------------------------------
# dispatch helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [7, 8])
def test_bound_tables_and_spatial_codes_match_reference(channels):
    """Pre-bound tables, their stacking (shared codebooks stack once) and
    the OR-tree code-domain encode, with out-of-alphabet codes clamped
    within their channel."""
    jbank, tbank = _banks(channels)
    jpipes = [jbank["a"], jbank["b"], jbank["a"]]
    tpipes = [tbank["a"], tbank["b"], tbank["a"]]
    jt, jrows = j_dispatch.stack_bound_tables(jpipes)
    tt, trows = dispatch.stack_bound_tables(tpipes)
    np.testing.assert_array_equal(hv.to_u32(tt), np.asarray(jt))
    np.testing.assert_array_equal(trows, jrows)
    np.testing.assert_array_equal(
        hv.to_u32(dispatch.bound_table(tbank["b"].params, tbank["b"].cfg)),
        np.asarray(j_dispatch.bound_table(jbank["b"].params, jbank["b"].cfg)))

    rng = np.random.default_rng(channels)
    codes = rng.integers(0, 90, (5, 37, channels), np.uint8)  # >= 64: clamped
    owner = np.asarray([0, 1, 1, 0, 1], np.int32)
    cfg = j_dispatch.datapath_key(jbank["a"].cfg)
    want = j_dispatch.owner_spatial_codes(jt, jnp.asarray(owner),
                                          jnp.asarray(codes), cfg)
    got = dispatch.owner_spatial_codes(tt, torch.from_numpy(owner),
                                       torch.from_numpy(codes),
                                       dispatch.datapath_key(tbank["a"].cfg))
    np.testing.assert_array_equal(hv.to_u32(got), np.asarray(want))
    assert dispatch.owner_spatial_codes(
        tt, torch.from_numpy(owner), torch.from_numpy(codes[:, :0]),
        tbank["a"].cfg).shape == (5, 0, DIM // 32)


# the adder-tree datapaths: dense majority, naive thinning, CompIM thinning
ADDER_CFGS = [dict(variant="dense"), dict(variant="sparse_naive", spatial_threshold=2),
              dict(spatial_thinning=True, spatial_threshold=3)]


@pytest.mark.parametrize("cfg_kw", ADDER_CFGS, ids=["dense", "naive", "thin"])
@pytest.mark.parametrize("channels", [7, 33])
def test_adder_dispatch_matches_reference(cfg_kw, channels):
    """Pre-bound tables (dense: XOR), the adder-tree code-domain encode
    against the reference's and against the reference formulation
    (``owner_spatial_encode``, which the thinned branch is held to
    directly), and batched frame encoding, over a T that no block length
    of 8 divides and out-of-alphabet codes."""
    jbank, tbank = _banks(channels, **cfg_kw)
    jt, _ = j_dispatch.stack_bound_tables([jbank["a"], jbank["b"]])
    tt, _ = dispatch.stack_bound_tables([tbank["a"], tbank["b"]])
    np.testing.assert_array_equal(hv.to_u32(tt), np.asarray(jt))
    jcfg = j_dispatch.datapath_key(jbank["a"].cfg)
    tcfg = dispatch.datapath_key(tbank["a"].cfg)
    rng = np.random.default_rng(channels)
    owner = np.asarray([0, 1, 1, 0], np.int32)
    codes = rng.integers(0, 80, (4, 2 * WINDOW + 6, channels), np.uint8)
    args = (torch.from_numpy(owner), torch.from_numpy(codes))
    jargs = (jnp.asarray(owner), jnp.asarray(codes))
    got = dispatch.owner_spatial_codes(tt, *args, tcfg)
    np.testing.assert_array_equal(hv.to_u32(got), np.asarray(
        _jit(j_dispatch.owner_spatial_codes, cfg=jcfg)(jt, *jargs)))
    enc = dispatch.owner_spatial_encode(tt, *args, tcfg)
    np.testing.assert_array_equal(hv.to_u32(enc), np.asarray(
        _jit(j_dispatch.owner_spatial_encode, cfg=jcfg)(jt, *jargs)))
    assert torch.equal(got, enc)
    assert dispatch.spatial_block_len(70, tcfg) == j_dispatch.spatial_block_len(70, jcfg)
    thr = np.asarray([4, 6, 6, 4], np.int32)
    np.testing.assert_array_equal(
        hv.to_u32(dispatch.owner_encode_frames(tt, args[0], torch.from_numpy(thr),
                                               args[1], tcfg)),
        np.asarray(_jit(j_dispatch.owner_encode_frames, cfg=jcfg)(
            jt, jargs[0], jnp.asarray(thr), jargs[1])))


def test_owner_spatial_encode_and_encode_frames_or_tree_match_reference():
    jbank, tbank = _banks(6)
    jt, _ = j_dispatch.stack_bound_tables([jbank["a"], jbank["c"]])
    tt, _ = dispatch.stack_bound_tables([tbank["a"], tbank["c"]])
    jcfg = j_dispatch.datapath_key(jbank["a"].cfg)
    tcfg = dispatch.datapath_key(tbank["a"].cfg)
    rng = np.random.default_rng(4)
    owner = np.asarray([1, 0, 1], np.int32)
    codes = rng.integers(0, 70, (3, 3 * WINDOW + 5, 6), np.uint8)
    enc = dispatch.owner_spatial_encode(tt, torch.from_numpy(owner),
                                        torch.from_numpy(codes), tcfg)
    np.testing.assert_array_equal(
        hv.to_u32(enc), np.asarray(_jit(j_dispatch.owner_spatial_encode, cfg=jcfg)(
            jt, jnp.asarray(owner), jnp.asarray(codes))))
    thr = np.asarray([5, 4, 5], np.int32)
    np.testing.assert_array_equal(
        hv.to_u32(dispatch.owner_encode_frames(
            tt, torch.from_numpy(owner), torch.from_numpy(thr),
            torch.from_numpy(codes), tcfg)),
        np.asarray(_jit(j_dispatch.owner_encode_frames, cfg=jcfg)(
            jt, jnp.asarray(owner), jnp.asarray(thr), jnp.asarray(codes))))


def test_owner_am_scores_and_datapath_key_match_reference():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 2**32, (4, 3, 8), dtype=np.uint32)
    rows = rng.integers(0, 2**32, (4, 1, 2, 8), dtype=np.uint32)
    jcfg = JConfig(dim=DIM, channels=6, window=WINDOW)
    tcfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    want = j_dispatch.owner_am_scores(jnp.asarray(frames), jnp.asarray(rows), jcfg)
    got = dispatch.owner_am_scores(torch.from_numpy(hv.to_i32(frames)),
                                   torch.from_numpy(hv.to_i32(rows)), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = dispatch.datapath_key(dataclasses.replace(tcfg, temporal_threshold=9,
                                                    class_density=0.3))
    jkey = j_dispatch.datapath_key(dataclasses.replace(jcfg, temporal_threshold=9,
                                                       class_density=0.3))
    assert key == convert.config_from_fields(dataclasses.asdict(jkey))


def test_validate_bank_rejects_what_reference_rejects():
    _, tbank = _banks(6)
    assert dispatch.validate_bank(tbank) == dispatch.datapath_key(tbank["a"].cfg)
    untrained = dataclasses.replace(tbank["a"], class_hvs=None)
    with pytest.raises(ValueError, match="untrained"):
        dispatch.validate_bank({"a": untrained})
    other = tbank["b"].with_cfg(spatial_threshold=3)
    other = dataclasses.replace(other, class_hvs=tbank["b"].class_hvs)
    with pytest.raises(ValueError, match="spatial_threshold"):
        dispatch.validate_bank({"a": tbank["a"], "b": other})
    with pytest.raises(ValueError, match="at least one"):
        dispatch.validate_bank({})


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def _check_ragged_schedule(channels: int, **cfg_kw) -> None:
    jbank, tbank = _banks(channels, **cfg_kw)
    owners = ["a", "b", "c", "b", "a", "c"]
    buckets = (8, 16, 64)
    jf = JFleet(jbank, owners, buckets=buckets, backend="jnp")
    tf = StreamingFleet(tbank, owners, buckets=buckets)
    rng = np.random.default_rng(11 + channels)
    schedules = [
        [0] * 6,                              # nothing at all
        [0, 5, 31, 32, 33, 0],               # zero, sub-window, crossing
        [90, 0, 64, 65, 7, 130],             # beyond the largest bucket
        [3, 3, 3, 3, 3, 3],
        list(rng.integers(0, 150, 6)),
        [200] * 6,                           # equal lengths, split
    ]
    total = 0
    for lens in schedules:
        chunks = [rng.integers(0, 72, (int(t), channels), np.uint8)
                  for t in lens]
        got, want = tf.push(chunks), jf.push(chunks)
        _assert_decisions_equal(got, want)
        total += sum(len(d) for d in got)
        _assert_state_equal(tf, jf)
    assert total > 20


@pytest.mark.parametrize("channels", [7, 8])
def test_fleet_ragged_schedule_matches_reference(channels):
    """Zero-length, sub-window, window-crossing and longer-than-bucket
    chunks, with out-of-alphabet codes, over three patients with their own
    codebooks and thresholds."""
    _check_ragged_schedule(channels)


@pytest.mark.parametrize("cfg_kw", ADDER_CFGS, ids=["dense", "naive", "thin"])
def test_variant_fleet_ragged_schedule_matches_reference(cfg_kw):
    """The same schedules through the fleet kernel's ``majority`` (dense)
    and ``thin`` (naive, CompIM with spatial thinning) modes; dense frames
    take the window majority and ignore the thresholds."""
    _check_ragged_schedule(7, **cfg_kw)


def test_fleet_push_codes_and_raw_rounds_match_reference():
    """Pre-stacked batches with per-session lengths, and the raw round API
    collected after several pushes."""
    jbank, tbank = _banks(6)
    owners = ["c", "a", "b", "a"]
    jf = JFleet(jbank, owners, buckets=(16, 32), backend="jnp")
    tf = StreamingFleet(tbank, owners, buckets=(16, 32))
    rng = np.random.default_rng(5)
    for t, lens in ((40, None), (40, [0, 40, 17, 33]), (1, [1, 0, 1, 1])):
        batch = rng.integers(0, 64, (4, t, 6), np.uint8)
        _assert_decisions_equal(tf.push_codes(batch, lens),
                                jf.push_codes(batch, lens))
    rounds_t, rounds_j = [], []
    for _ in range(3):
        batch = rng.integers(0, 64, (4, 50, 6), np.uint8)
        rounds_t += tf.push_codes_raw(batch)
        rounds_j += jf.push_codes_raw(batch)
    assert [r.n_emit.tolist() for r in rounds_t] == [r.n_emit.tolist() for r in rounds_j]
    _assert_decisions_equal(tf.collect_decisions(rounds_t),
                            jf.collect_decisions(rounds_j))
    _assert_state_equal(tf, jf)
    tf.reset()
    jf.reset()
    _assert_state_equal(tf, jf)


def test_fleet_guards():
    _, tbank = _banks(6)
    with pytest.raises(KeyError, match="unknown patient"):
        StreamingFleet(tbank, ["a", "zz"])
    with pytest.raises(ValueError, match="at least one session"):
        StreamingFleet(tbank, [])
    with pytest.raises(ValueError, match="buckets"):
        StreamingFleet(tbank, ["a"], buckets=(0, 8))
    fleet = StreamingFleet(tbank, ["a", "b"])
    with pytest.raises(ValueError, match="one chunk per session"):
        fleet.push([np.zeros((4, 6), np.uint8)])
    with pytest.raises(ValueError, match="chunk must be"):
        fleet.push([np.zeros((4, 5), np.uint8), np.zeros((4, 6), np.uint8)])
    with pytest.raises(ValueError, match="lengths must be"):
        fleet.push_codes(np.zeros((2, 4, 6), np.uint8), [5, 0])
    assert fleet.push([np.zeros((0, 6), np.uint8)] * 2) == [[], []]
    assert fleet.device == torch.device("cpu") and fleet.n_sessions == 2
