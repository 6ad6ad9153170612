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


# ---------------------------------------------------------------------------
# capacity tiles
# ---------------------------------------------------------------------------

def _cycle(n: int, pids=("a", "b", "c")) -> list:
    return [pids[i % len(pids)] for i in range(n)]


def test_tiled_fleet_matches_reference():
    """37 sessions in tiles of 16: three tiles (one launch each a round)
    and 11 phantom slots.  Ragged schedules, a round in which the middle
    tile has no live cycle, a split round and an ``adapt``; the state rows
    (phantoms included), fill levels and ``_meta()`` agree."""
    jbank, tbank = _banks(6)
    owners = _cycle(37)
    jf = JFleet(jbank, owners, buckets=(16, 32), backend="jnp", tile=16)
    tf = StreamingFleet(tbank, owners, buckets=(16, 32), tile=16)
    assert tf.n_tiles == jf.n_tiles == 3 and tf.n_sessions == 37
    assert tf.state.counts.shape[0] == np.asarray(jf.state.counts).shape[0] == 48
    assert tf._meta() == jf._meta()
    rng = np.random.default_rng(21)
    idle_middle = rng.integers(0, 80, 37)
    idle_middle[16:32] = 0
    for lens in (rng.integers(0, 80, 37), idle_middle, np.full(37, 70),
                 rng.integers(0, 40, 37)):
        chunks = [rng.integers(0, 72, (int(t), 6), np.uint8) for t in lens]
        _assert_decisions_equal(tf.push(chunks), jf.push(chunks))
        _assert_state_equal(tf, jf)
    labels = rng.integers(-1, 2, 37)
    np.testing.assert_array_equal(tf.adapt(labels), np.asarray(jf.adapt(labels)))
    _assert_state_equal(tf, jf)
    chunks = [rng.integers(0, 64, (40, 6), np.uint8) for _ in range(37)]
    _assert_decisions_equal(tf.push(chunks), jf.push(chunks))
    np.testing.assert_array_equal(tf.class_rows, np.asarray(jf.class_rows))


@pytest.mark.parametrize("n", [10, 70])
def test_default_tile_pads_like_reference(n):
    """At the default tile on the CPU (256, capped at the fleet's size
    rounded up to a power of two) both packages provision the same rows:
    10 sessions keep their exact size, 70 pad to 128."""
    jbank, tbank = _banks(6)
    owners = _cycle(n)
    jf = JFleet(jbank, owners, buckets=(32,), backend="jnp")
    tf = StreamingFleet(tbank, owners, buckets=(32,))
    rows = np.asarray(jf.state.counts).shape[0]
    assert rows == {10: 10, 70: 128}[n]
    assert tf.state.counts.shape[0] == rows and tf.n_tiles == jf.n_tiles == 1
    assert tf._meta() == jf._meta()
    rng = np.random.default_rng(n)
    chunks = [rng.integers(0, 64, (int(t), 6), np.uint8)
              for t in rng.integers(0, 70, n)]
    _assert_decisions_equal(tf.push(chunks), jf.push(chunks))
    _assert_state_equal(tf, jf)
    assert tf.fill_levels.shape == (n,)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_padded_checkpoint_restores_across_packages(tmp_path, direction):
    """70 sessions at ``tile=256`` (the reference pads to 256 rows): each
    package restores the other's checkpoint and continues equal to the
    uninterrupted fleet of the other package."""
    from test_torch_engine import _banks as _engine_banks

    jbank, tbank = _engine_banks()
    owners = _cycle(70)
    jf = JFleet(jbank, owners, buckets=(8, 32), backend="jnp", tile=256)
    tf = StreamingFleet(tbank, owners, buckets=(8, 32), tile=256)
    assert tf.state.counts.shape[0] == np.asarray(jf.state.counts).shape[0] == 256
    assert tf._meta() == jf._meta()
    rng = np.random.default_rng(17)
    chans = tbank["a"].cfg.channels
    for _ in range(2):
        chunks = [rng.integers(0, 64, (int(t), chans), np.uint8)
                  for t in rng.integers(0, 50, 70)]
        _assert_decisions_equal(tf.push(chunks), jf.push(chunks))
        labels = rng.integers(-1, 2, 70)
        np.testing.assert_array_equal(tf.adapt(labels), np.asarray(jf.adapt(labels)))
    root = str(tmp_path / "ckpt")
    if direction == "port_to_reference":
        tf.save(root)
        resumed, live = JFleet(jbank, owners, buckets=(8, 32), backend="jnp",
                               tile=256), tf
    else:
        jf.save(root)
        resumed, live = StreamingFleet(tbank, owners, buckets=(8, 32), tile=256), jf
    assert resumed.restore(root) == 0
    np.testing.assert_array_equal(resumed.fill_levels, live.fill_levels)
    for _ in range(2):
        chunks = [rng.integers(0, 64, (int(t), chans), np.uint8)
                  for t in rng.integers(0, 50, 70)]
        _assert_decisions_equal(resumed.push(chunks), live.push(chunks))


def test_derive_tile_matches_reference(monkeypatch):
    """``REPRO_FLEET_TILE`` set (valid or not) and unset on the CPU: the
    same tile, or the same error."""
    from repro.serve.fleet import derive_tile as j_derive_tile
    from repro_torch.serve.fleet import DEFAULT_TILE, derive_tile

    jcfg = JConfig(dim=DIM, segments=SEGMENTS, channels=6, window=WINDOW)
    tcfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    monkeypatch.delenv("REPRO_FLEET_TILE", raising=False)
    assert derive_tile(tcfg, device="cpu") == j_derive_tile(jcfg) == DEFAULT_TILE
    for env in ("64", "128", "4096"):
        monkeypatch.setenv("REPRO_FLEET_TILE", env)
        assert derive_tile(tcfg, device="cpu") == j_derive_tile(jcfg) == int(env)
    for env in ("abc", "100", "32", "8192"):
        monkeypatch.setenv("REPRO_FLEET_TILE", env)
        with pytest.raises(ValueError) as want:
            j_derive_tile(jcfg)
        with pytest.raises(ValueError) as got:
            derive_tile(tcfg, device="cpu")
        assert str(got.value) == str(want.value)
    monkeypatch.setenv("REPRO_FLEET_TILE", "64")
    _, tbank = _banks(6)
    fleet = StreamingFleet(tbank, _cycle(100), buckets=(32,))
    assert fleet.n_tiles == 2 and fleet.state.counts.shape[0] == 128
