"""Deploy artifacts and warm-up (``repro_torch.runtime.aot``, the fleets'
``aot_entries``/``warmup``/``save(aot_dir=)``/``from_artifact``) held
against the reference's ``repro.runtime.aot`` and fleets.

On the CPU there is no kernel library and nothing to capture: ``warmup``
reports every entry skipped, and the artifact tests write a stand-in file
in place of the library (``build.build`` is patched; the CPU has no
nvcc).  What is held here: the key and its staleness rule, the manifest,
the entry set against the reference's, the checkpoint's ``aot`` entry, and
that warmed, restored and cross-package-restored fleets decide bit for bit
as the uninterrupted ones do.

Tolerance: exact equality (integer and bit arithmetic; JSON fields).
"""

import json
import os
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.runtime import aot as j_aot
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.kernels import build
from repro_torch.runtime import aot
from repro_torch.serve.fleet import StreamingFleet
from repro_torch.serve.lifecycle import ElasticFleet
from test_torch_fleet import _assert_decisions_equal, _assert_state_equal, _banks

jax.config.update("jax_platform_name", "cpu")

CH = 8
BUCKETS = (32, 64)
OWNERS = ["a", "b", "c", "a", "b"]


@pytest.fixture(scope="module")
def banks():
    return _banks(CH)


@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    """A stand-in for the built kernel library (the CPU has no nvcc)."""
    lib = tmp_path / "libhdc_kernels_0123456789abcdef.so"
    lib.write_bytes(b"not a real library")
    monkeypatch.setattr(build, "build", lambda: lib)
    return lib


def _push(fleets, rng, lengths):
    chunks = [rng.integers(0, 64, (int(t), CH), np.uint8) for t in lengths]
    return [f.push(chunks) for f in fleets]


def test_fingerprint_is_stable_and_follows_the_sources(tmp_path):
    fp = aot.kernel_fingerprint()
    assert fp == aot.kernel_fingerprint() == build.digest()
    assert len(fp) == 16 and int(fp, 16) >= 0
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    assert aot.kernel_fingerprint(copy) == fp
    src = sorted(copy.glob("*.cu"))[0]
    src.write_text(src.read_text() + "\n// edited\n")
    edited = aot.kernel_fingerprint(copy)
    assert edited != fp
    (copy / "extra.cuh").write_text("// new header\n")
    assert aot.kernel_fingerprint(copy) not in (fp, edited)


def test_artifact_key_and_stale_fields():
    key = aot.artifact_key(device="cpu")
    assert key == {"format": aot.ARTIFACT_VERSION, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "device": "cpu", "capability": None,
                   "kernels": aot.kernel_fingerprint()}
    assert aot.stale_fields(key, key) == {}
    moved = dict(key, kernels="0" * 16, torch="0.0")
    assert aot.stale_fields(moved, key) == {"kernels": ("0" * 16, key["kernels"]),
                                            "torch": ("0.0", key["torch"])}
    # the same rule as the reference's, on either package's keys
    jkey = j_aot.artifact_key()
    for saved, current in ((key, jkey), (jkey, key), (moved, key), (key, key)):
        assert aot.stale_fields(saved, current) == j_aot.stale_fields(saved, current)
    # every field the reference's key lacks is stale (here None-valued ones
    # match its absence: the CPU build of torch has no CUDA version)
    assert set(aot.stale_fields(jkey, key)) == {k for k, v in key.items() if v is not None}


def test_manifest_written_read_back_and_stale_refused(tmp_path, fake_library):
    key = aot.artifact_key(device="cpu")
    entries = [aot.AOTEntry("fleet.x.cpu.s4.t32.step.abc", "step", 4, 32),
               aot.AOTEntry("fleet.x.cpu.s4.adapt.abc", "adapt", 4)]
    path = str(tmp_path / "art")
    manifest = aot.save_artifact(path, entries, key=key)
    assert sorted(os.listdir(path)) == sorted([aot.MANIFEST, fake_library.name])
    assert not os.path.exists(path + ".tmp")
    with open(os.path.join(path, aot.MANIFEST)) as f:
        assert json.load(f) == manifest
    assert manifest["entries"][1] == {"name": "fleet.x.cpu.s4.adapt.abc",
                                      "kind": "adapt", "tile": 4, "bucket": None}
    art = aot.load_artifact(path, device="cpu")
    assert art.key == key and art.names == [e.name for e in entries]
    assert entries[0].name in art and "fleet.other" not in art
    assert art.library.read_bytes() == fake_library.read_bytes()
    # rewriting replaces the artifact whole
    aot.save_artifact(path, entries[:1], key=key)
    assert aot.load_artifact(path, device="cpu").names == [entries[0].name]
    with pytest.warns(UserWarning, match="stale: kernels"):
        assert aot.load_artifact(path, expected_key=dict(key, kernels="f" * 16)) is None
    with pytest.warns(UserWarning, match="unreadable manifest"):
        assert aot.load_artifact(str(tmp_path / "missing"), device="cpu") is None
    with pytest.raises(ValueError, match="duplicate"):
        aot.save_artifact(path, entries + entries[:1], key=key)
    with pytest.raises(ValueError, match="kind"):
        aot.AOTEntry("x", "jit", 1)


def _fields(name: str) -> tuple:
    """An entry name without its backend and program digest."""
    parts = name.split(".")
    return tuple(p for i, p in enumerate(parts) if i not in (2, len(parts) - 1))


@pytest.mark.parametrize("kw", [{}, {"channel_masking": True}], ids=["plain", "masked"])
def test_entries_follow_the_reference_naming(banks, kw):
    jbank, tbank = banks
    owners = OWNERS * 20            # 100 sessions: tiles of 64 pad to 128
    jf = JFleet(jbank, owners, backend="jnp", buckets=BUCKETS, tile=64, **kw)
    tf = StreamingFleet(tbank, owners, buckets=BUCKETS, tile=64, **kw)
    want = [_fields(e.name) for e in jf.aot_entries()]
    got = tf.aot_entries()
    assert [_fields(e.name) for e in got] == want
    assert [(e.kind, e.tile, e.bucket) for e in got] == [
        ("step", 64, 32), ("step", 64, 64), ("adapt", 64, None)]
    assert all(e.name.split(".")[2] == "cpu" for e in got)


def test_cpu_warmup_skips_every_entry_and_decides_as_unwarmed(banks):
    jbank, tbank = banks
    warm = StreamingFleet(tbank, OWNERS, buckets=BUCKETS)
    cold = StreamingFleet(tbank, OWNERS, buckets=BUCKETS)
    ref = JFleet(jbank, OWNERS, backend="jnp", buckets=BUCKETS)
    n = len(warm.aot_entries())
    assert warm.warmup() == {"loaded": 0, "compiled": 0, "skipped": n}
    assert warm.warmup(buckets=(32,)) == {"loaded": 0, "compiled": 0, "skipped": 2}
    assert warm.aot_count == 0 and warm.capture_ms == {}
    rng = np.random.default_rng(5)
    for lengths in ([40] * 5, [0, 3, 64, 100, 31]):
        got, want, ref_d = _push((warm, cold, ref), rng, lengths)
        _assert_decisions_equal(got, want)
        _assert_decisions_equal(got, ref_d)
    labels = np.asarray([0, 1, -1, 1, 0])
    np.testing.assert_array_equal(warm.adapt(labels), np.asarray(ref.adapt(labels)))
    _assert_state_equal(warm, ref)


def test_save_with_aot_dir_and_from_artifact_resume_bit_exactly(tmp_path, banks,
                                                               fake_library):
    _, tbank = banks
    live = StreamingFleet(tbank, OWNERS, buckets=BUCKETS)
    rng = np.random.default_rng(6)
    _push([live], rng, [50, 20, 70, 0, 33])
    root, art = str(tmp_path / "ckpt"), str(tmp_path / "aot")
    path = live.save(root, aot_dir=art)
    with open(os.path.join(path, "manifest.json")) as f:
        entry = json.load(f)["aot"]
    assert entry == {"path": art, "key": aot.artifact_key(device="cpu")}
    assert aot.load_artifact(art, device="cpu").names == [
        e.name for e in live.aot_entries()]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a valid artifact warns nothing
        resumed = StreamingFleet.from_artifact(tbank, OWNERS, root, buckets=BUCKETS)
    with pytest.warns(UserWarning, match="unreadable manifest"):
        cold = StreamingFleet.from_artifact(tbank, OWNERS, root, warm=False,
                                            aot_dir=str(tmp_path / "none"),
                                            buckets=BUCKETS)
    np.testing.assert_array_equal(resumed.fill_levels, live.fill_levels)
    for lengths in ([64] * 5, [1, 2, 90, 5, 60]):
        got, want, other = _push((resumed, live, cold), rng, lengths)
        _assert_decisions_equal(got, want)
        _assert_decisions_equal(other, want)


def test_elastic_checkpoint_with_aot_dir_resumes_and_from_artifact_refuses(
        tmp_path, banks, fake_library):
    _, tbank = banks
    kw = dict(tile=4, max_tiles=3, buckets=BUCKETS)
    live = ElasticFleet(tbank, **kw)
    sids = [live.admit(pid) for pid in ["a", "b", "c", "a", "b", "c"]]   # spills
    rng = np.random.default_rng(7)
    live.push_sessions({s: rng.integers(0, 64, (45, CH), np.uint8) for s in sids})
    root, art = str(tmp_path / "ckpt"), str(tmp_path / "aot")
    live.save(root, aot_dir=art)
    resumed = ElasticFleet.from_checkpoint(tbank, root, **kw)
    assert resumed.sessions == live.sessions and resumed.n_tiles == 2
    chunks = {s: rng.integers(0, 64, (70, CH), np.uint8) for s in sids}
    got, want = resumed.push_sessions(chunks), live.push_sessions(chunks)
    for s in sids:
        _assert_decisions_equal([got[s]], [want[s]])
    with pytest.raises(NotImplementedError, match="from_checkpoint"):
        ElasticFleet.from_artifact(tbank, ["a"], root)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_checkpoint_aot_entry_of_the_other_package_restores_with_a_stale_warning(
        tmp_path, banks, fake_library, monkeypatch, direction):
    """Each package's checkpoint records its own artifact key; the other
    package finds every field stale, warns, warms without the artifact and
    restores, and then decides as the uninterrupted fleet."""
    jbank, tbank = banks
    jf = JFleet(jbank, OWNERS, backend="jnp", buckets=BUCKETS)
    tf = StreamingFleet(tbank, OWNERS, buckets=BUCKETS)
    rng = np.random.default_rng(8)
    got, want = _push((tf, jf), rng, [40, 12, 64, 80, 3])
    _assert_decisions_equal(got, want)
    root, art = str(tmp_path / "ckpt"), str(tmp_path / "aot")
    if direction == "port_to_reference":
        tf.save(root, aot_dir=art)
        with pytest.warns(UserWarning, match="checkpoint AOT entry is stale"):
            resumed = JFleet.from_artifact(jbank, OWNERS, root, warm=False,
                                           backend="jnp", buckets=BUCKETS)
        live = tf
    else:
        # the reference's executables are not needed for the key it records
        monkeypatch.setattr(JFleet, "save_aot", lambda self, path: {})
        jf.save(root, aot_dir=art)
        with open(os.path.join(root, "step_00000000", "manifest.json")) as f:
            assert json.load(f)["aot"]["key"] == j_aot.artifact_key()
        with pytest.warns(UserWarning, match="checkpoint AOT entry is stale"):
            resumed = StreamingFleet.from_artifact(tbank, OWNERS, root, buckets=BUCKETS)
        live = jf
    np.testing.assert_array_equal(resumed.fill_levels, live.fill_levels)
    for lengths in ([64] * 5, [7, 0, 33, 90, 64]):
        got, want = _push((resumed, live), rng, lengths)
        _assert_decisions_equal(got, want)
