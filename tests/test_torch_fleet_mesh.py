"""The port's fleet on several devices: capacity tiles round-robin over the
local devices, and the SPMD mesh fleet (``StreamingFleet(mesh=)``) on 1, 2
and 4 CPU ranks, held against the JAX package's UNSHARDED fleet (the
reference's own mesh tests fail under the installed jax), and masked and
faulted mesh fleets against the port's unsharded ones.

Multi-rank cases start one plain process a rank (``tests/mesh_worker.py``)
over a ``gloo`` group on a ``file://`` store; the reference's decisions
are computed here and handed to the ranks as ``.npz``.  Every spawn and
collective has a timeout.

Tolerance: exact equality (integer and bit arithmetic throughout).
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mesh_worker
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch import device as device_mod
from repro_torch.serve.fleet import StreamingFleet
from repro_torch.serve.lifecycle import ElasticFleet
from test_torch_fleet import _assert_decisions_equal, _assert_state_equal, _banks, _cycle

BUCKETS = (8, 16, 64)
CHANNELS = 6


def _schedule(n: int, seed: int, pushes: int = 5) -> dict:
    """Ragged pushes (zero, sub-window, longer than the largest bucket) and
    feedback labels after the second and fourth."""
    rng = np.random.default_rng(seed)
    out = {"n_push": pushes}
    for i in range(pushes):
        lens = rng.integers(0, 150, n)
        lens[rng.random(n) < 0.2] = 0
        out[f"lens{i}"] = lens
        out[f"batch{i}"] = rng.integers(0, 72, (n, int(lens.max()) + 1, CHANNELS), np.uint8)
        if i in (1, 3):
            out[f"labels{i}"] = rng.integers(-1, 2, n)
    return out


def _reference_run(jf: JFleet, sched: dict, parts=None) -> dict:
    """The reference's decisions (flattened) for every push, its adapt
    verdicts and its final rows."""
    want = {}
    for i in range(sched["n_push"]) if parts is None else parts:
        want[f"fill{i}"] = jf.fill_levels
        dec = jf.push(mesh_worker.chunks_of(sched[f"batch{i}"], sched[f"lens{i}"]))
        want.update({f"p{i}.{k}": v for k, v in mesh_worker.flat_decisions(dec).items()})
        if f"labels{i}" in sched and parts is None:
            want[f"adapt{i}"] = np.asarray(jf.adapt(sched[f"labels{i}"]))
    want["rows"] = np.asarray(jf.state.counts).shape[0]
    want["fill_levels"] = jf.fill_levels
    want["class_rows"] = np.asarray(jf.class_rows)
    want["counts"] = np.asarray(jf.state.counts)
    return want


def _data_dir(tmp_path, tbank, sched: dict, want: dict) -> str:
    data = str(tmp_path / "data")
    os.makedirs(data)
    mesh_worker.save_bank(os.path.join(data, "bank"), tbank)
    np.savez(os.path.join(data, "schedule.npz"), **sched)
    np.savez(os.path.join(data, "expect.npz"), **want)
    return data


# ---------------------------------------------------------------------------
# tiles over the local devices
# ---------------------------------------------------------------------------

@pytest.fixture
def two_devices(monkeypatch):
    """Two local devices, both the CPU: the round-robin bookkeeping (tile
    devices, per-device tables, per-device registers) runs as on a host
    with two cards."""
    monkeypatch.setattr(device_mod, "local_devices", lambda kind: [torch.device(kind)] * 2)


def test_tiles_over_two_devices_match_one_device(two_devices, tmp_path):
    """37 sessions in tiles of 16 over two devices: ragged rounds, adapt,
    save and restore equal the reference's tiled fleet (one device)."""
    jbank, tbank = _banks(CHANNELS)
    owners = _cycle(37)
    jf = JFleet(jbank, owners, buckets=BUCKETS, backend="jnp", tile=16)
    tf = StreamingFleet(tbank, owners, buckets=BUCKETS, tile=16)
    assert tf.n_tiles == 3 and len(tf._tile_devs) == 3 and len(tf._devs) == 2
    sched = _schedule(37, seed=3)
    for i in range(sched["n_push"]):
        chunks = mesh_worker.chunks_of(sched[f"batch{i}"], sched[f"lens{i}"])
        _assert_decisions_equal(tf.push(chunks), jf.push(chunks))
        if f"labels{i}" in sched:
            np.testing.assert_array_equal(tf.adapt(sched[f"labels{i}"]),
                                          np.asarray(jf.adapt(sched[f"labels{i}"])))
    _assert_state_equal(tf, jf)
    tf.save(str(tmp_path))
    again = StreamingFleet(tbank, owners, buckets=BUCKETS, tile=16)
    again.restore(str(tmp_path))
    _assert_state_equal(again, jf)
    assert tf.warmup()["compiled"] == 0   # the CPU captures nothing


def test_elastic_tiles_over_two_devices_match_one_device(two_devices, tmp_path, monkeypatch):
    """An elastic fleet spilling to three tiles over two devices, through
    admit, push, evict, compaction, save and ``from_checkpoint``, equals the
    same fleet on one device (held against the reference in
    ``test_torch_lifecycle.py``)."""
    _, tbank = _banks(CHANNELS)
    two = ElasticFleet(tbank, tile=4, max_tiles=3)
    monkeypatch.setattr(device_mod, "local_devices", lambda kind: [torch.device(kind)])
    one = ElasticFleet(tbank, tile=4, max_tiles=3)
    monkeypatch.setattr(device_mod, "local_devices", lambda kind: [torch.device(kind)] * 2)
    rng = np.random.default_rng(9)
    pids = list(tbank)
    for f in (two, one):
        for i in range(10):
            f.admit(pids[i % 3])
    assert two.capacity == one.capacity == 12 and len(two._tile_devs) == 3
    for rnd in range(4):
        sids = list(two.sessions)
        chunks = {s: rng.integers(0, 64, (int(rng.integers(0, 70)), CHANNELS), np.uint8)
                  for s in sids}
        got, want = two.push_sessions(chunks), one.push_sessions(chunks)
        assert got.keys() == want.keys()
        for s in got:
            _assert_decisions_equal([got[s]], [want[s]])
        if rnd == 1:
            drop = sids[4:9]
            snaps = two.evict(drop)
            one.evict(drop)
            assert two.compact() == one.compact() == 1
            for s in drop[:2]:
                two.admit(snaps[s].patient_id, snapshot=snaps[s])
                one.admit(snaps[s].patient_id, snapshot=snaps[s])
    np.testing.assert_array_equal(two.class_rows, one.class_rows)
    two.save(str(tmp_path))
    back = ElasticFleet.from_checkpoint(tbank, str(tmp_path), tile=4, max_tiles=3)
    assert back.sessions == one.sessions and len(back._tile_devs) == back.n_tiles
    chunks = {s: rng.integers(0, 64, (40, CHANNELS), np.uint8) for s in one.sessions}
    got, want = back.push_sessions(chunks), one.push_sessions(chunks)
    for s in got:
        _assert_decisions_equal([got[s]], [want[s]])


# ---------------------------------------------------------------------------
# the mesh fleet
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group (over a FileStore in a fresh temporary
    directory) and a (1,) ``data`` mesh on the CPU, torn down after."""
    from repro_torch.launch.mesh import make_mesh

    assert not dist.is_initialized()
    mesh = make_mesh((1,), ("data",), device="cpu", timeout_s=60)
    yield mesh
    dist.destroy_process_group()


def test_mesh_fleet_one_rank_matches_reference(one_rank_mesh, tmp_path):
    """At world size 1 the mesh fleet decides as the reference's unsharded
    fleet over ragged rounds and adapts; a reference checkpoint restores
    onto the mesh; warm-up warns and captures nothing; a deploy artifact is
    refused."""
    jbank, tbank = _banks(CHANNELS)
    owners = _cycle(70)
    jf = JFleet(jbank, owners, buckets=BUCKETS, backend="jnp")
    tf = StreamingFleet(tbank, owners, buckets=BUCKETS, mesh=one_rank_mesh)
    assert tf.mesh is one_rank_mesh and tf.n_tiles == 1
    sched = _schedule(70, seed=5)
    for i in range(3):
        chunks = mesh_worker.chunks_of(sched[f"batch{i}"], sched[f"lens{i}"])
        _assert_decisions_equal(tf.push(chunks), jf.push(chunks))
        if f"labels{i}" in sched:
            np.testing.assert_array_equal(tf.adapt(sched[f"labels{i}"]),
                                          np.asarray(jf.adapt(sched[f"labels{i}"])))
    _assert_state_equal(tf, jf)
    root = str(tmp_path / "ref")
    jf.save(root)
    back = StreamingFleet(tbank, owners, buckets=BUCKETS, mesh=one_rank_mesh)
    assert back.restore(root) == 0
    for i in range(3, 5):
        chunks = mesh_worker.chunks_of(sched[f"batch{i}"], sched[f"lens{i}"])
        _assert_decisions_equal(back.push(chunks), jf.push(chunks))
    with pytest.warns(UserWarning, match="eagerly"):
        assert back.warmup() == {"loaded": 0, "compiled": 0, "skipped": 0}
    with pytest.raises(ValueError, match="without a mesh"):
        back.save_aot(str(tmp_path / "aot"))


@pytest.mark.parametrize("mesh,n", [((2,), 12), ((4,), 70), ((2, 2), 12), ((4,), 10)],
                         ids=["data2", "data4", "data2xmodel2", "data4-replicated"])
def test_mesh_fleet_ranks_match_reference(tmp_path, mesh, n):
    """On 2 and 4 gloo ranks, and a 2 x 2 ``data``/``model`` mesh (the
    ``model`` axis holds copies), every rank's decisions, adapt verdicts,
    class rows, fill levels and gathered state equal the reference's
    unsharded fleet; 70 sessions pad to 128 rows (32 a rank), and 10
    sessions over 4 ranks replicate (10 % 4 != 0).  Masked and faulted
    (BER 1e-2 then 5e-2, SECDED) mesh fleets equal the port's unsharded
    ones, ECC counts included."""
    jbank, tbank = _banks(CHANNELS)
    owners = _cycle(n)
    sched = _schedule(n, seed=n)
    want = _reference_run(JFleet(jbank, owners, buckets=BUCKETS, backend="jnp"), sched)
    data = _data_dir(tmp_path, tbank, sched, want)
    axes = {1: ["data"], 2: ["data", "model"]}[len(mesh)]
    # each rank's block of the capacity over the data axis (all of it when
    # the data axis does not divide it)
    rows = want["rows"] if want["rows"] % mesh[0] else want["rows"] // mesh[0]
    mesh_worker.spawn("fleet", {"mesh": list(mesh), "axes": axes, "owners": owners,
                                "buckets": list(BUCKETS), "data": data,
                                "local_rows": int(rows)},
                      str(tmp_path / "group"))
