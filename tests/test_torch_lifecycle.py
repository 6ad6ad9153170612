"""The port's elastic fleet (``repro_torch.serve.lifecycle``) held against
the JAX package's ``ElasticFleet(backend="jnp")`` at ``tile=4``,
``max_tiles=2``, with the reference's trained pipelines transferred through
``repro_torch.convert``: admission, eviction and readmission (across the
packages too), spill, compaction, backpressure, the slot maps under random
churn, incremental checkpoints, restore + replay, and each package's
elastic checkpoint restored by the other.

Tolerance: exact equality.  Decisions (frame index, prediction, scores,
frame HV), snapshots, ``stats``, ``op_id``, checkpoint leaves and manifest
meta are integer, bit and bookkeeping state; error messages are compared
as text.
"""

import base64
import json
import os

import jax
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.serve.engine import SessionSnapshot as JSnapshot
from repro.serve.lifecycle import CapacityError as JCapacityError
from repro.serve.lifecycle import ElasticFleet as JElastic
from repro_torch.serve.engine import SeizureSession, SessionSnapshot
from repro_torch.serve.lifecycle import CapacityError, ElasticFleet
from test_torch_online import CHANNELS, WINDOW, _chunk, _jtrained, _transfer

jax.config.update("jax_platform_name", "cpu")

BUCKETS = (32, 64)
SNAPSHOT_ARRAYS = ("counts", "class_rows", "am_counts", "am_n", "last_frame",
                   "last_scores", "channel_mask")
SNAPSHOT_SCALARS = ("patient_id", "filled", "frame_index", "has_frame")


def _make_banks(variant: str):
    jbank = {f"p{i}": _jtrained(variant, i, temporal_threshold=4 + i)
             for i in range(2)}
    return jbank, {pid: _transfer(p) for pid, p in jbank.items()}


@pytest.fixture(scope="module")
def banks():
    return _make_banks("sparse_compim")


def _pair(banks, **kw):
    kw.setdefault("tile", 4)
    kw.setdefault("max_tiles", 2)
    kw.setdefault("queue_limit", 2)
    kw.setdefault("buckets", BUCKETS)
    jbank, tbank = banks
    return JElastic(jbank, backend="jnp", **kw), ElasticFleet(tbank, **kw)


def _assert_same_decisions(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.frame_index == y.frame_index
        assert x.prediction == y.prediction
        np.testing.assert_array_equal(np.asarray(x.scores), np.asarray(y.scores))
        np.testing.assert_array_equal(np.asarray(x.frame_hv), np.asarray(y.frame_hv))


def _push_both(jf, tf, chunks):
    """The same push on both fleets; returns the port's decisions."""
    want, got = jf.push_sessions(chunks), tf.push_sessions(chunks)
    assert got.keys() == want.keys()
    for sid in got:
        _assert_same_decisions(got[sid], want[sid])
    return got


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


def _assert_books_equal(tf, jf):
    """The lifecycle bookkeeping of the two packages agrees."""
    assert tf.sessions == jf.sessions
    assert {s: tf.slot_of(s) for s in tf.sessions} == \
        {s: jf.slot_of(s) for s in jf.sessions}
    assert (tf.capacity, tf.n_tiles, tf.free_slots, tf.queue_depth,
            tf.overloaded, tf.op_id) == (jf.capacity, jf.n_tiles,
                                         jf.free_slots, jf.queue_depth,
                                         jf.overloaded, jf.op_id)
    assert tf.stats == jf.stats


def _slot_invariants(fleet):
    """The free-slot map's safety properties every op must keep."""
    occupied = set(fleet._slot_sid)
    free = set().union(*fleet._free) if fleet._free else set()
    assert len(fleet._sid_slot) == len(set(fleet._sid_slot.values()))
    assert {s: k for k, s in fleet._sid_slot.items()} == fleet._slot_sid
    assert free.isdisjoint(occupied)
    assert free | occupied == set(range(fleet.capacity))
    assert (fleet._filled_h < WINDOW).all()
    assert len(fleet._state_t) == fleet.n_tiles == len(fleet._dirty_t)
    assert fleet.state.counts.shape[0] == fleet.capacity


def _raises_alike(fn_ref, fn_port, exc=Exception):
    with pytest.raises(exc) as want:
        fn_ref()
    with pytest.raises(exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# admission / eviction / reconnect
# ---------------------------------------------------------------------------

def test_admit_push_evict_matches_reference(banks):
    """Two sessions pushed ragged chunks (zero-length and sub-window ones
    included): decisions equal the reference fleet's and a port
    ``SeizureSession`` each; the eviction snapshots equal the reference's."""
    _, tbank = banks
    rng = np.random.default_rng(0)
    jf, tf = _pair(banks)
    s0, s1 = tf.admit("p0"), tf.admit("p1")
    assert (s0, s1) == (jf.admit("p0"), jf.admit("p1"))
    ref0, ref1 = SeizureSession(tbank["p0"]), SeizureSession(tbank["p1"])
    for t in (WINDOW + 7, 2 * WINDOW, 5, 0, WINDOW - 5):
        c0, c1 = _chunk(rng, t), _chunk(rng, max(t - 3, 0))
        got = _push_both(jf, tf, {s0: c0, s1: c1})
        _assert_same_decisions(got[s0], ref0.push(c0))
        _assert_same_decisions(got[s1], ref1.push(c1))
        _slot_invariants(tf)
    assert tf.adapt({s0: 1, s1: 0}) == jf.adapt({s0: 1, s1: 0})
    snaps, jsnaps = tf.evict([s0, s1]), jf.evict([s0, s1])
    for sid in (s0, s1):
        _assert_snapshots_equal(snaps[sid], jsnaps[sid])
    assert snaps[s0].patient_id == "p0"
    assert tf.sessions == {} and tf.free_slots == tf.capacity
    _assert_books_equal(tf, jf)
    _slot_invariants(tf)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_evict_readmit_across_packages(banks, direction):
    """A session evicted mid-window in one package, its snapshot through
    the wire encoding, readmitted in the other: it stays equal to a session
    that never dropped, its next ``adapt`` included."""
    _, tbank = banks
    rng = np.random.default_rng(1)
    jf, tf = _pair(banks)
    src, dst = (tf, jf) if direction == "port_to_reference" else (jf, tf)
    dst_snapshot = JSnapshot if dst is jf else SessionSnapshot
    ref = SeizureSession(tbank["p0"])
    sid = src.admit("p0")
    c1 = _chunk(rng, WINDOW + 11)                 # ends mid-window
    _assert_same_decisions(src.push_sessions({sid: c1})[sid], ref.push(c1))
    snap = src.evict([sid])[sid]
    assert snap.filled == 11 and snap.frame_index == 1
    sid2 = dst.admit("p0", snapshot=dst_snapshot.from_bytes(snap.to_bytes()))
    c2 = _chunk(rng, 2 * WINDOW)
    _assert_same_decisions(dst.push_sessions({sid2: c2})[sid2], ref.push(c2))
    assert dst.adapt({sid2: 1}) == {sid2: ref.adapt(1)}
    c3 = _chunk(rng, WINDOW)
    _assert_same_decisions(dst.push_sessions({sid2: c3})[sid2], ref.push(c3))


def test_admission_validation_matches_reference(banks):
    """Unknown patients and sessions, a snapshot of another patient, and
    the constructor's guards raise as in the reference."""
    jf, tf = _pair(banks)
    jbank, tbank = banks
    _raises_alike(lambda: jf.admit("nobody"), lambda: tf.admit("nobody"), KeyError)
    sj, st_ = jf.admit("p0"), tf.admit("p0")
    snap_j, snap_t = jf.evict([sj])[sj], tf.evict([st_])[st_]
    _raises_alike(lambda: jf.admit("p1", snapshot=snap_j),
                  lambda: tf.admit("p1", snapshot=snap_t), ValueError)
    _raises_alike(lambda: jf.evict([99]), lambda: tf.evict([99]), KeyError)
    zeros = np.zeros((4, CHANNELS), np.uint8)
    _raises_alike(lambda: jf.push_sessions({99: zeros}),
                  lambda: tf.push_sessions({99: zeros}), KeyError)
    _raises_alike(lambda: jf.adapt({99: 1}), lambda: tf.adapt({99: 1}), KeyError)
    _raises_alike(lambda: JElastic(jbank, tile=1, backend="jnp"),
                  lambda: ElasticFleet(tbank, tile=1), ValueError)
    _raises_alike(lambda: JElastic(jbank, tile=4, max_tiles=0, backend="jnp"),
                  lambda: ElasticFleet(tbank, tile=4, max_tiles=0), ValueError)
    _raises_alike(lambda: JElastic({}, tile=4), lambda: ElasticFleet({}, tile=4),
                  ValueError)
    _assert_books_equal(tf, jf)


# ---------------------------------------------------------------------------
# spill / compaction / backpressure
# ---------------------------------------------------------------------------

def test_spill_compact_and_capacity_error(banks):
    rng = np.random.default_rng(3)
    jf, tf = _pair(banks)
    sids = [tf.admit("p0") for _ in range(4)]
    assert sids == [jf.admit("p0") for _ in range(4)]
    assert tf.n_tiles == 1 and tf.free_slots == 0
    spilled = tf.admit("p1")                      # the fifth session spills
    assert spilled == jf.admit("p1")
    assert tf.n_tiles == 2 and tf.capacity == 8 and tf.stats["spills"] == 1
    _assert_books_equal(tf, jf)
    _slot_invariants(tf)
    _push_both(jf, tf, {spilled: _chunk(rng, WINDOW), sids[0]: _chunk(rng, 9)})
    for _ in range(3):
        assert tf.admit("p0") == jf.admit("p0")
    with pytest.raises(CapacityError):
        tf.admit("p0")
    with pytest.raises(JCapacityError):
        jf.admit("p0")
    # drain tile 0, then compact: the spilled tile's survivors move into
    # earlier free slots and the trailing tile is dropped
    for f in (jf, tf):
        f.evict(sids, with_state=False)
        f.evict([s for s in f.sessions if s != spilled], with_state=False)
    assert tf.compact() == jf.compact() == 1
    assert tf.n_tiles == 1 and tf.capacity == 4 and tf.slot_of(spilled) < 4
    _assert_books_equal(tf, jf)
    _slot_invariants(tf)
    _push_both(jf, tf, {spilled: _chunk(rng, WINDOW + 3)})


def test_offer_queue_shed_drain_and_degraded_adapt(banks):
    rng = np.random.default_rng(4)
    jf, tf = _pair(banks, max_tiles=1, queue_limit=2)
    keep = tf.admit("p0")
    assert keep == jf.admit("p0")
    _push_both(jf, tf, {keep: _chunk(rng, WINDOW)})
    others = [tf.admit("p0") for _ in range(3)]
    assert others == [jf.admit("p0") for _ in range(3)]
    verdicts = [(tf.offer("p1"), jf.offer("p1")) for _ in range(3)]
    assert [t for t, _ in verdicts] == [j for _, j in verdicts]
    assert [t[0] for t, _ in verdicts] == ["queued", "queued", "shed"]
    assert tf.overloaded and tf.queue_depth == 2
    # decision-only mode: adapt is shed, decisions keep flowing
    assert tf.adapt({keep: 1}) == jf.adapt({keep: 1}) == {keep: False}
    assert len(_push_both(jf, tf, {keep: _chunk(rng, WINDOW)})[keep]) == 1
    _assert_books_equal(tf, jf)
    # evictions drain the queue oldest first
    for f in (jf, tf):
        f.evict(others[:2], with_state=False)
    assert not tf.overloaded
    assert sorted(tf.sessions.values()).count("p1") == 2
    _assert_books_equal(tf, jf)
    _slot_invariants(tf)
    assert tf.adapt({keep: 1}) == jf.adapt({keep: 1}) == {keep: True}
    assert tf.stats["adapt_shed"] == 1


@settings(max_examples=8, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["admit", "evict", "compact", "offer"]),
                          st.integers(0, 7)),
                min_size=1, max_size=12))
def test_slot_map_invariants_hold_under_churn(ops):
    """Any sequence of admissions, offers, evictions and compactions keeps
    the slot maps a bijection and a partition of the capacity, and the
    bookkeeping equal to the reference's."""
    jbank, tbank = _BANK_P0
    kw = dict(tile=2, max_tiles=2, queue_limit=1, buckets=BUCKETS)
    jf, tf = JElastic(jbank, backend="jnp", **kw), ElasticFleet(tbank, **kw)
    for op, arg in ops:
        for f, cap_err in ((jf, JCapacityError), (tf, CapacityError)):
            if op == "admit":
                try:
                    f.admit("p0")
                except cap_err:
                    pass
            elif op == "offer":
                f.offer("p0")
            elif op == "evict":
                live = sorted(f.sessions)
                if live:
                    f.evict([live[arg % len(live)]], with_state=bool(arg % 2))
            else:
                f.compact()
        _slot_invariants(tf)
        _assert_books_equal(tf, jf)


_BANK_P0 = (lambda jp: ({"p0": jp}, {"p0": _transfer(jp)}))(
    _jtrained("sparse_compim", 0))


# ---------------------------------------------------------------------------
# durability: incremental checkpoints, restore, replay, both packages
# ---------------------------------------------------------------------------

def _inodes(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return {leaf["key"]: os.stat(os.path.join(path, leaf["file"])).st_ino
                for leaf in json.load(f)["leaves"]}


def test_incremental_checkpoint_links_the_reference_leaf_set(banks, tmp_path):
    """Two tiles; after the first save only tile 1 advances: the second
    save hard-links the same leaves in both packages (all of tile 0) and
    rewrites the rest."""
    rng = np.random.default_rng(6)
    jf, tf = _pair(banks)
    a = tf.admit("p0")
    assert a == jf.admit("p0")
    for _ in range(4):
        assert tf.admit("p0") == jf.admit("p0")
    spilled = [s for s in tf.sessions if tf.slot_of(s) >= 4][0]
    _push_both(jf, tf, {a: _chunk(rng, WINDOW), spilled: _chunk(rng, WINDOW)})
    linked = {}
    for name, f in (("ref", jf), ("port", tf)):
        root = str(tmp_path / name)
        first = _inodes(f.save(root))
        f.push_sessions({spilled: np.zeros((8, CHANNELS), np.uint8)})
        second = _inodes(f.save(root))
        linked[name] = {k for k in first if first[k] == second[k]}
    assert linked["port"] == linked["ref"]
    assert {k for k in linked["port"]} == {k for k in _inodes(
        str(tmp_path / "port" / "step_00000001")) if k.startswith("tile_00/")}


def test_restore_replay_matches_uninterrupted_run(banks, tmp_path):
    """Checkpoint, keep serving (churn and decisions), crash; a new fleet
    restores and replays the events after the cursor: its replayed and
    later decisions equal the fleet that never died."""
    rng = np.random.default_rng(7)
    root = str(tmp_path / "ckpt")
    _, tf = _pair(banks, log_rounds=64)
    a, b = tf.admit("p0"), tf.admit("p1")
    tf.push_sessions({a: _chunk(rng, 2 * WINDOW + 5), b: _chunk(rng, WINDOW)})
    tf.save(root)
    cursor = tf.op_id
    live = []
    c1, c2 = _chunk(rng, WINDOW + 2), _chunk(rng, WINDOW)
    live.append(tf.push_sessions({a: c1, b: c1}))
    b2 = tf.admit("p1", snapshot=tf.evict([b])[b])
    live.append(tf.push_sessions({a: c2, b2: c2}))
    tf.adapt({a: 1})
    events = tf.events_since(cursor)
    post = _chunk(rng, 2 * WINDOW)
    live_final = tf.push_sessions({a: post, b2: post})

    restored = ElasticFleet(banks[1], tile=4, max_tiles=2, buckets=BUCKETS)
    restored.admit("p0")
    for _ in range(4):
        restored.admit("p1")                      # two tiles: restore drops one
    assert restored.restore(root) == 0
    assert restored.n_tiles == 1 and restored.sessions == {a: "p0", b: "p1"}
    replayed = restored.replay(events)
    pushes = [v for op, v in replayed.items() if events[op - cursor][1] == "push"]
    assert len(pushes) == len(live)
    for want, got in zip(live, pushes):
        assert want.keys() == got.keys()
        for sid in want:
            _assert_same_decisions(got[sid], want[sid])
    re_final = restored.push_sessions({a: post, b2: post})
    for sid in live_final:
        _assert_same_decisions(re_final[sid], live_final[sid])
    assert restored.sessions == tf.sessions and restored.op_id == tf.op_id


def test_replay_gap_and_ring_overflow_errors_match_reference(banks):
    jf, tf = _pair(banks)
    for f in (jf, tf):
        f.admit("p0")
    _raises_alike(lambda: jf.replay([(jf.op_id + 3, "compact", ())]),
                  lambda: tf.replay([(tf.op_id + 3, "compact", ())]), ValueError)
    jf, tf = _pair(banks, log_rounds=2)
    for f in (jf, tf):
        sid = f.admit("p0")
        for _ in range(4):
            f.evict([sid], with_state=False)
            sid = f.admit("p0")
    _raises_alike(lambda: jf.events_since(0), lambda: tf.events_since(0), ValueError)
    assert [e[:2] for e in tf.events_since(8)] == [e[:2] for e in jf.events_since(8)]


def _decoded_meta(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    meta = manifest["meta"]
    queue = meta["lifecycle"].pop("queue")
    return manifest["leaves"], meta, [
        (pid, None if b64 is None else SessionSnapshot.from_bytes(base64.b64decode(b64)))
        for pid, b64 in queue]


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_elastic_checkpoint_crosses_packages(banks, tmp_path, direction):
    """Two tiles full, a queued arrival carrying a snapshot: the port's
    checkpoint has the reference's leaf keys, shapes, dtypes and arrays and
    its manifest meta (the queued snapshot compared decoded); each
    package's ``from_checkpoint`` restores the other's checkpoint, queue
    included, and continues equal to the live fleet of the other."""
    rng = np.random.default_rng(8)
    jf, tf = _pair(banks, queue_limit=2)
    for i in range(8):
        assert tf.admit(f"p{i % 2}") == jf.admit(f"p{i % 2}")
    _push_both(jf, tf, {s: _chunk(rng, int(rng.integers(0, 70))) for s in tf.sessions})
    assert tf.adapt({0: 1, 5: 0}) == jf.adapt({0: 1, 5: 0})
    snap_t, snap_j = tf.evict([3])[3], jf.evict([3])[3]
    _push_both(jf, tf, {0: _chunk(rng, 20)})
    assert tf.admit("p1") == jf.admit("p1")       # the freed slot again
    assert tf.offer("p1", snapshot=snap_t) == jf.offer("p1", snapshot=snap_j) == \
        ("queued", None)
    paths = {"port": tf.save(str(tmp_path / "port")),
             "ref": jf.save(str(tmp_path / "ref"))}
    (t_leaves, t_meta, t_queue), (j_leaves, j_meta, j_queue) = (
        _decoded_meta(paths["port"]), _decoded_meta(paths["ref"]))
    assert t_leaves == j_leaves and t_meta == j_meta
    assert [p for p, _ in t_queue] == [p for p, _ in j_queue]
    for (_, a), (_, b) in zip(t_queue, j_queue):
        _assert_snapshots_equal(a, b)
    for leaf in t_leaves:
        np.testing.assert_array_equal(
            np.load(os.path.join(paths["port"], leaf["file"])),
            np.load(os.path.join(paths["ref"], leaf["file"])))

    kw = dict(tile=4, max_tiles=2, queue_limit=2, buckets=BUCKETS)
    if direction == "port_to_reference":
        resumed = JElastic.from_checkpoint(banks[0], str(tmp_path / "port"),
                                           backend="jnp", warm=False, **kw)
        live = tf
    else:
        resumed = ElasticFleet.from_checkpoint(banks[1], str(tmp_path / "ref"), **kw)
        live = jf
    port_f, ref_f = (live, resumed) if live is tf else (resumed, live)
    _assert_books_equal(port_f, ref_f)
    assert resumed.n_tiles == 2 and resumed.queue_depth == 1
    for f in (resumed, live):
        f.evict([5], with_state=False)            # drains the queued snapshot
    _assert_books_equal(port_f, ref_f)
    chunks = {s: _chunk(rng, int(rng.integers(0, 70))) for s in live.sessions}
    got, want = resumed.push_sessions(chunks), live.push_sessions(chunks)
    for sid in want:
        _assert_same_decisions(got[sid], want[sid])
    labels = {s: int(rng.integers(0, 2)) for s in live.sessions}
    assert resumed.adapt(labels) == live.adapt(labels)


def test_dense_elastic_fleet_matches_reference():
    """The dense variant (the fleet kernel's ``majority`` mode): admit,
    spill, push, adapt, evict and readmit equal to the reference."""
    rng = np.random.default_rng(9)
    jf, tf = _pair(_make_banks("dense"))
    for i in range(5):
        assert tf.admit(f"p{i % 2}") == jf.admit(f"p{i % 2}")
    assert tf.n_tiles == 2
    for _ in range(2):
        _push_both(jf, tf, {s: _chunk(rng, int(rng.integers(0, 70))) for s in tf.sessions})
    assert tf.adapt({0: 1, 4: 0}) == jf.adapt({0: 1, 4: 0})
    snap_t, snap_j = tf.evict([4])[4], jf.evict([4])[4]
    _assert_snapshots_equal(snap_t, snap_j)
    assert tf.admit("p0", snapshot=snap_t) == jf.admit("p0", snapshot=snap_j)
    _push_both(jf, tf, {s: _chunk(rng, 50) for s in tf.sessions})
    _assert_books_equal(tf, jf)
