"""The port's reliability layer held against the JAX package: the word
primitives (``hv.word_parity``, ``hv.random_flip_mask``), the ECC codecs and
their energy model (``reliability/ecc.py``), the fault campaign
(``reliability/faults.py``) and the faulted ``StreamingFleet``
(``faults=``, ``set_ber``, ``ecc_stats``).

``jax.random`` cannot be replayed by torch, so the port draws its own
masks.  Parity therefore takes three forms: bit-exactness at BER 0 (here);
bit-exactness of the step, and equal ECC counts, when the port is handed
the masks the reference draws (``tests/test_torch_faulted_step.py``).  The
port's sampler is checked by statistics: rates within five standard
deviations of the binomial mean.

Tolerance: exact equality everywhere else (integer and bit arithmetic; the
energy model repeats the reference's float arithmetic in the same order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hv as j_hv
from repro.core import hwmodel as j_hwmodel
from repro.reliability import ecc as j_ecc
from repro.reliability import faults as j_faults
from repro.serve.fleet import StreamingFleet as JFleet
from repro_torch.core import hv, hwmodel
from repro_torch.reliability import ecc, faults
from repro_torch.reliability.faults import FaultConfig, FaultPlan, StepDraw
from repro_torch.serve.fleet import StreamingFleet
from test_torch_online import WINDOW, _assert_decisions_equal, _chunk, _jtrained, _transfer

jax.config.update("jax_platform_name", "cpu")


def _words(seed: int, n: int) -> np.ndarray:
    """Seeded uint32 words, with bit 31 set in about half and the edge
    words 0, 1, 0x80000000 and 0xFFFFFFFF first."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w[:4] = (0, 1, 0x80000000, 0xFFFFFFFF)
    return w


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(hv.to_i32(np.asarray(words, np.uint32)).copy())


def _u(words: torch.Tensor) -> np.ndarray:
    return hv.to_u32(words)


# ---------------------------------------------------------------------------
# word primitives and the ECC codecs
# ---------------------------------------------------------------------------

def test_word_parity_matches_reference():
    w = _words(0, 4096)
    np.testing.assert_array_equal(hv.word_parity(_t(w)).numpy(),
                                  np.asarray(j_hv.word_parity(jnp.asarray(w))))


@pytest.mark.parametrize("scheme", ["none", "parity", "secded"])
def test_encode_matches_reference(scheme):
    w = _words(1, 4096)
    got = ecc.encode(_t(w), scheme)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u(got), np.asarray(j_ecc.encode(jnp.asarray(w), scheme)))


def _corruptions(seed: int, scheme: str):
    """(data, check) pairs of every flip class the scheme meets: each
    single data-bit flip (bit 31 included), each single check-bit flip,
    double data flips, a data and a check flip, and clean words."""
    w = _words(seed, 64)
    chk = np.asarray(j_ecc.encode(jnp.asarray(w), scheme)).astype(np.uint32)
    n_chk = j_ecc.n_check_bits(scheme)
    rng = np.random.default_rng(seed + 100)
    data, check = [], []
    for j in range(64):
        for b in range(32):                                   # single data
            data.append(w[j] ^ np.uint32(1 << b)), check.append(chk[j])
        for b in range(n_chk):                                # single check
            data.append(w[j]), check.append(chk[j] ^ np.uint32(1 << b))
        b1, b2 = rng.choice(32, 2, replace=False)             # double data
        data.append(w[j] ^ np.uint32((1 << int(b1)) | (1 << int(b2))))
        check.append(chk[j])
        if n_chk:                                             # data + check
            data.append(w[j] ^ np.uint32(1 << int(b1)))
            check.append(chk[j] ^ np.uint32(1 << int(rng.integers(n_chk))))
        data.append(w[j]), check.append(chk[j])               # clean
    return np.asarray(data, np.uint32), np.asarray(check, np.uint32)


@pytest.mark.parametrize("scheme", ["none", "parity", "secded"])
def test_decode_matches_reference(scheme):
    """Corrected words and status equal the reference's on every flip
    class; SECDED corrects every single flip and flags every double."""
    data, check = _corruptions(2, scheme)
    got_w, got_s = ecc.decode(_t(data), _t(check), scheme)
    want_w, want_s = j_ecc.decode(jnp.asarray(data), jnp.asarray(check), scheme)
    np.testing.assert_array_equal(_u(got_w), np.asarray(want_w))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s.dtype == torch.int32
    if scheme == "secded":
        per_word = 32 + 7 + 1 + 1 + 1
        status = got_s.numpy().reshape(64, per_word)
        assert (status[:, :39] == ecc.CORRECTED).all()
        assert (status[:, 39] == ecc.UNCORRECTABLE).all()
        assert (status[:, -1] == ecc.CLEAN).all()
        clean = _words(2, 64)
        np.testing.assert_array_equal(_u(got_w).reshape(64, per_word)[:, :39],
                                      np.repeat(clean[:, None], 39, 1))
    if scheme == "parity":
        status = got_s.numpy().reshape(64, 32 + 1 + 1 + 1 + 1)
        assert (status[:, :33] == ecc.UNCORRECTABLE).all()   # odd flips
        assert (status[:, 33:] == ecc.CLEAN).all()           # even, clean


def test_scheme_validation_and_check_bits():
    for fn in (ecc.n_check_bits, ecc.ops_per_word):
        with pytest.raises(ValueError, match="unknown ECC scheme"):
            fn("hamming74")
    for fn in (ecc.encode, ecc.decode):
        with pytest.raises(ValueError, match="unknown ECC scheme"):
            fn(*[torch.zeros(1, dtype=torch.int32)] * (1 + (fn is ecc.decode)), "hamming74")
    assert [ecc.n_check_bits(s) for s in ecc.SCHEMES] == \
        [j_ecc.n_check_bits(s) for s in j_ecc.SCHEMES]
    assert ecc.SCHEMES == j_ecc.SCHEMES
    assert (ecc.CLEAN, ecc.CORRECTED, ecc.UNCORRECTABLE) == \
        (j_ecc.CLEAN, j_ecc.CORRECTED, j_ecc.UNCORRECTABLE)
    np.testing.assert_array_equal(ecc._PARITY_MASKS, j_ecc._PARITY_MASKS)
    np.testing.assert_array_equal(_u(ecc._synd_flip(torch.device("cpu"))),
                                  j_ecc._SYND_FLIP)


@pytest.mark.parametrize("scheme", ["none", "parity", "secded"])
def test_energy_model_matches_reference(scheme):
    hot = dict(e_gate_op=j_hwmodel.C16.e_gate_op * 10, e_fa_op=4.5)
    t_hot, j_hot = hwmodel.HWConstants(**hot), j_hwmodel.HWConstants(**hot)
    assert dataclasses.asdict(hwmodel.C16) == dataclasses.asdict(j_hwmodel.C16)
    assert ecc.ops_per_word(scheme) == j_ecc.ops_per_word(scheme)
    for n_classes, words in ((2, 8), (2, 32), (3, 64)):
        assert ecc.read_ops(scheme, n_classes, words) == j_ecc.read_ops(scheme, n_classes, words)
        assert ecc.raw_am_read_ops(n_classes, words) == j_ecc.raw_am_read_ops(n_classes, words)
        for t_c, j_c in ((hwmodel.C16, j_hwmodel.C16), (t_hot, j_hot)):
            assert ecc.read_energy_nj(scheme, n_classes, words, t_c) == \
                j_ecc.read_energy_nj(scheme, n_classes, words, j_c)
            assert ecc.read_overhead(scheme, n_classes, words, t_c) == \
                j_ecc.read_overhead(scheme, n_classes, words, j_c)
    ops = {"xor2": 3, "and2": 5, "or2": 7, "fa": 11, "ff": 13, "cmp_bit": 17}
    assert hwmodel.gate_energy_fj(ops) == j_hwmodel.gate_energy_fj(ops)
    with pytest.raises(ValueError, match="unknown gate kinds"):
        hwmodel.gate_energy_fj({"nand3": 1})


# ---------------------------------------------------------------------------
# the fault campaign
# ---------------------------------------------------------------------------

def _err(cls, **kw) -> str:
    with pytest.raises(ValueError) as e:
        cls(**kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(mode="cosmic"), dict(ecc="bch"), dict(am=1.5),
                                dict(tables=-0.1), dict(counts_bits=0),
                                dict(counts_bits=33)])
def test_fault_config_validation_matches_reference(kw):
    assert _err(FaultConfig, **kw) == _err(j_faults.FaultConfig, **kw)


def test_fault_config_plan_vector_and_with_ber():
    for kw in (dict(tables=1e-3, counts=0.0, ecc="secded"),
               dict(am=0.25, mode="stuck", seed=9, counts_bits=8),
               dict(), dict(ecc="parity")):
        t, j = FaultConfig(**kw), j_faults.FaultConfig(**kw)
        assert dataclasses.asdict(t.plan()) == dataclasses.asdict(j.plan())
        assert t.plan().any_target == j.plan().any_target
        np.testing.assert_array_equal(t.ber_vector(), j.ber_vector())
        assert t.ber_vector().dtype == np.float32
        for ber in (0.0, 1e-4, 0.5, 1.0):
            assert dataclasses.asdict(t.with_ber(ber)) == dataclasses.asdict(j.with_ber(ber))
        with pytest.raises(ValueError) as a:
            t.with_ber(-0.2)
        with pytest.raises(ValueError) as b:
            j.with_ber(-0.2)
        assert str(a.value) == str(b.value)
    assert faults.MODES == j_faults.MODES and faults.TARGETS == j_faults.TARGETS


def test_counter_bits_and_step_seed_match_reference():
    for cb in (None, 3, 8, 32):
        for window in (1, 31, 32, 255, 256, 257, 1000):
            assert faults.counter_bits(FaultPlan(counts_bits=cb), window) == \
                j_faults.counter_bits(j_faults.FaultPlan(counts_bits=cb), window)
    for mode in faults.MODES:
        for seed in (0, 7, 1000):
            t, j = FaultPlan(am=True, mode=mode, seed=seed), \
                j_faults.FaultPlan(am=True, mode=mode, seed=seed)
            for n_tiles in (1, 2, 5):
                for tile in range(n_tiles):
                    for phase in range(6):
                        kw = dict(tile=tile, n_tiles=n_tiles, phase=phase)
                        assert faults.step_seed(t, **kw) == j_faults.step_seed(j, **kw)


def test_component_keys_are_deterministic_and_independent():
    a = [g.initial_seed() for g in faults.component_keys(3, "cpu")]
    assert a == [g.initial_seed() for g in faults.component_keys(3, "cpu")]
    seeds = {g.initial_seed() for s in range(64) for g in faults.component_keys(s, "cpu")}
    assert len(seeds) == 64 * 3
    m = [hv.random_flip_mask(g, (256,), 0.5) for g in faults.component_keys(3, "cpu")]
    assert not torch.equal(m[0], m[1]) and not torch.equal(m[1], m[2])


# ---------------------------------------------------------------------------
# the sampler, by statistics
# ---------------------------------------------------------------------------

def _rate_ok(hits: int, n: int, p: float) -> bool:
    return abs(hits - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def _bits_set(words: torch.Tensor) -> int:
    return int(hv.lax_popcount(words).sum())


@pytest.mark.parametrize("p", [1e-3, 1e-2, 0.1])
@pytest.mark.parametrize("bits", [32, 9])
def test_flip_mask_rate(p, bits):
    g = torch.Generator().manual_seed(11)
    m = hv.random_flip_mask(g, (64, 1024), p, bits)
    assert m.shape == (64, 1024) and m.dtype == torch.int32
    assert _rate_ok(_bits_set(m), m.numel() * bits, p)
    if bits < 32:
        assert (m >> bits == 0).all()
    else:   # bit 31 is drawn like the others
        assert _rate_ok(int((m < 0).sum()), m.numel(), p)


def test_flip_mask_extremes_and_chunks(monkeypatch):
    g = torch.Generator().manual_seed(0)
    assert not hv.random_flip_mask(g, (33, 7), 0.0).any()
    assert (hv.random_flip_mask(g, (16,), 1.0) == -1).all()
    assert (hv.random_flip_mask(g, (16,), 1.0, bits=5) == 0x1F).all()
    assert hv.random_flip_mask(g, (), 1.0, bits=3).item() == 7
    for bad in (0, 33, -1):
        with pytest.raises(ValueError, match="bits"):
            hv.random_flip_mask(g, (4,), 0.5, bits=bad)
    # a mask larger than one piece of uniforms: the pieces tile it exactly
    monkeypatch.setattr(hv, "_FLIP_CHUNK", 100)
    whole = hv.random_flip_mask(torch.Generator().manual_seed(4), (3, 50), 1.0, bits=7)
    assert (whole == 0x7F).all()
    m = hv.random_flip_mask(torch.Generator().manual_seed(4), (300,), 0.3, bits=7)
    assert _rate_ok(_bits_set(m), 300 * 7, 0.3) and (m >> 7 == 0).all()


def test_stuck_draw_is_persistent_and_reads_flip_at_half_rate():
    """Stuck mode: one seed gives one draw (the persistent cells); a read
    flips where the stored bit differs from the stuck value, at rate
    ber / 2 on random data; complementing the data complements the flips
    inside the selected cells."""
    shape, p = (128, 256), 0.2
    d1 = faults.draw_words(faults.component_keys(5, "cpu")[1], shape, p, mode="stuck")
    d2 = faults.draw_words(faults.component_keys(5, "cpu")[1], shape, p, mode="stuck")
    assert torch.equal(d1.sel, d2.sel) and torch.equal(d1.val, d2.val)
    assert _rate_ok(_bits_set(d1.sel), d1.sel.numel() * 32, p)
    w = _t(_words(6, shape[0] * shape[1]).reshape(shape))
    m1 = faults.xor_mask(w, d1)
    assert _rate_ok(_bits_set(m1), m1.numel() * 32, p / 2)
    m2 = faults.xor_mask(~w, d1)
    np.testing.assert_array_equal((m1 ^ m2).numpy(), (m1 | m2).numpy())
    np.testing.assert_array_equal((m1 | m2).numpy(), d1.sel.numpy())
    read = faults.flip_words(w, d1)
    np.testing.assert_array_equal((read & d1.sel).numpy(), (d1.val & d1.sel).numpy())
    np.testing.assert_array_equal((read & ~d1.sel).numpy(), (w & ~d1.sel).numpy())
    t1 = faults.draw_words(faults.component_keys(5, "cpu")[1], shape, p)
    assert t1.val is None and torch.equal(faults.xor_mask(w, t1), t1.sel)
    with pytest.raises(ValueError, match="mode"):
        faults.draw_words(torch.Generator(), shape, p, mode="cosmic")


@pytest.mark.parametrize("mode", ["transient", "stuck"])
def test_flip_counts_stays_in_range(mode):
    counts = torch.full((4096,), 5, dtype=torch.int32)
    d = faults.draw_words(torch.Generator().manual_seed(8), (4096,), 1.0, bits=3, mode=mode)
    out = faults.flip_counts(counts, d)
    assert out.dtype == torch.int32
    assert ((out >= 0) & (out <= 7)).all()
    if mode == "transient":
        assert (out == 2).all()
    vals = torch.arange(512, dtype=torch.int32)
    d = faults.draw_words(torch.Generator().manual_seed(9), (512,), 0.3, bits=9, mode=mode)
    out = faults.flip_counts(vals, d)
    assert ((out >= 0) & (out < 512)).all() and not torch.equal(out, vals)


def test_draw_step_covers_the_plan():
    shapes = dict(tables_shape=(2, 4, 8, 3), rows_shape=(5, 2, 3),
                  counts_shape=(5, 96), window=32, device="cpu")
    ber = FaultConfig(tables=1.0, am=1.0, counts=1.0).ber_vector()
    d = faults.draw_step(FaultPlan(tables=True, am=True, counts=True, ecc="secded"),
                         ber, 4, **shapes)
    assert (d.tables.sel == -1).all() and (d.am.sel == -1).all()
    assert (d.am_check.sel == 0x7F).all() and (d.counts.sel == 0x3F).all()
    d = faults.draw_step(FaultPlan(am=True, mode="stuck"), ber, 4, **shapes)
    assert d.tables is None and d.counts is None and d.am_check is None
    assert d.am.val is not None and d.am.sel.shape == (5, 2, 3)
    assert faults.draw_step(FaultPlan(ecc="secded"), ber, 4, **shapes) == StepDraw()


# ---------------------------------------------------------------------------
# the faulted fleet
# ---------------------------------------------------------------------------

def _rounds(rng, s: int, n: int, ragged: bool = True):
    hi = 70 if ragged else WINDOW
    return [[_chunk(rng, int(t) if ragged else WINDOW) for t in rng.integers(0, hi, s)]
            for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _step_bank(variant: str):
    kw = dict(spatial_thinning=True, spatial_threshold=3) if variant == "thin" else {}
    v = "sparse_compim" if variant == "thin" else variant
    return {f"p{i}": _jtrained(v, i, temporal_threshold=4 + i, **kw) for i in range(2)}


@functools.lru_cache(maxsize=None)
def _banks(variant: str):
    jbank = _step_bank(variant)
    return jbank, {pid: _transfer(p) for pid, p in jbank.items()}


@functools.lru_cache(maxsize=None)
def _reference_decisions(variant: str):
    """Ragged rounds and the reference fleet's decisions on them."""
    owners = ["p0", "p1", "p1", "p0", "p1"]
    ref = JFleet(_banks(variant)[0], owners, buckets=(16, 32), backend="jnp")
    rounds = _rounds(np.random.default_rng(1), len(owners), 3)
    return owners, rounds, [ref.push(chunks) for chunks in rounds]


@pytest.mark.parametrize("variant", ["sparse_compim", "dense"])
@pytest.mark.parametrize("mode", ["transient", "stuck"])
def test_zero_ber_fleet_decides_as_reference(variant, mode):
    """Every target faulted at BER 0, SECDED on: decisions equal the
    reference fleet's (without faults) on ragged rounds, over two tiles;
    ``ecc_stats`` stays zero; ``fault_config`` is the campaign given."""
    owners, rounds, want = _reference_decisions(variant)
    fc = FaultConfig(tables=0.0, am=0.0, counts=0.0, mode=mode, ecc="secded")
    port = StreamingFleet(_banks(variant)[1], owners, buckets=(16, 32), faults=fc, tile=4)
    assert port.n_tiles == 2 and port.fault_config == fc
    for chunks, w_round in zip(rounds, want):
        for g, w in zip(port.push(chunks), w_round):
            _assert_decisions_equal(g, w)
    assert port.ecc_stats.shape == (5, 3) and port.ecc_stats.dtype == np.int64
    assert not port.ecc_stats.any()


def _decisions(fleet, rounds):
    out = []
    for chunks in rounds:
        out.extend(d for ds in fleet.push(chunks) for d in ds)
    return out


def test_high_ber_changes_decisions():
    _, tbank = _banks("sparse_compim")
    owners = ["p0", "p1"] * 3
    rounds = _rounds(np.random.default_rng(2), 6, 3, ragged=False)
    clean = _decisions(StreamingFleet(tbank, owners, buckets=(32,)), rounds)
    for fc in (FaultConfig(tables=0.05), FaultConfig(am=0.05), FaultConfig(counts=0.05),
               FaultConfig(tables=0.05, am=0.05, counts=0.05, mode="stuck")):
        got = _decisions(StreamingFleet(tbank, owners, buckets=(32,), faults=fc), rounds)
        assert len(got) == len(clean)
        assert any(not np.array_equal(a.scores, b.scores) for a, b in zip(got, clean)), fc


def test_secded_recovers_low_ber_am_faults():
    """AM faults at 2e-4 under SECDED: decisions equal the clean fleet's,
    words were corrected, none uncorrectable (detected == corrected)."""
    _, tbank = _banks("sparse_compim")
    owners = ["p0", "p1"] * 4
    rounds = _rounds(np.random.default_rng(3), 8, 8, ragged=False)
    clean = StreamingFleet(tbank, owners, buckets=(32,))
    prot = StreamingFleet(tbank, owners, buckets=(32,),
                          faults=FaultConfig(am=2e-4, ecc="secded", seed=11))
    for a, b in zip(_decisions(prot, rounds), _decisions(clean, rounds)):
        _assert_decisions_equal([a], [b])
    st = prot.ecc_stats.sum(axis=0)
    assert st[0] > 0 and st[2] == 0 and st[1] == st[0]


def test_set_ber_reset_and_persistence():
    """``set_ber`` moves every enabled target and drops the stuck draws;
    ``reset`` zeroes the ECC counters; stuck faults corrupt identical
    inputs identically every round (and the kept draw equals a fresh one),
    transient faults do not; a fleet without faults refuses ``set_ber``."""
    _, tbank = _banks("sparse_compim")
    owners = ["p0", "p1"] * 2
    chunk = _chunk(np.random.default_rng(6), WINDOW)

    def per_round_events(fleet):
        events = []
        for _ in range(3):
            before = fleet.ecc_stats.sum()
            fleet.push([chunk] * 4)
            events.append(int(fleet.ecc_stats.sum() - before))
        return events

    stuck = StreamingFleet(tbank, owners, buckets=(32,),
                           faults=FaultConfig(am=0.01, mode="stuck", ecc="secded", seed=3))
    ev = per_round_events(stuck)
    assert ev[0] > 0 and len(set(ev)) == 1
    kept = stuck._stuck_draws[0]
    fresh = faults.draw_step(stuck._plan, stuck.fault_config.ber_vector(),
                             faults.step_seed(stuck._plan, tile=0, n_tiles=1, phase=7),
                             tables_shape=stuck._tables.shape, rows_shape=(4, 2, 8),
                             counts_shape=(4, 256), window=WINDOW, device="cpu")
    assert torch.equal(kept.am.sel, fresh.am.sel) and torch.equal(kept.am.val, fresh.am.val)
    trans = StreamingFleet(tbank, owners, buckets=(32,),
                           faults=FaultConfig(am=0.01, ecc="secded", seed=3))
    assert len(set(per_round_events(trans))) > 1

    stuck.set_ber(0.05)
    assert stuck.fault_config.am == 0.05 and stuck.fault_config.tables is None
    assert not stuck._stuck_draws
    assert stuck.ecc_stats.sum() > 0
    stuck.reset()
    assert stuck.ecc_stats.sum() == 0 and stuck.ecc_stats.shape == (4, 3)
    assert per_round_events(stuck)[0] > ev[0]
    stuck.set_ber(0.0)
    stuck.reset()
    per_round_events(stuck)
    assert stuck.ecc_stats.sum() == 0

    plain = StreamingFleet(tbank, owners, buckets=(32,))
    with pytest.raises(ValueError, match="faults"):
        plain.set_ber(0.1)
    with pytest.raises(ValueError) as a:
        plain.set_ber(0.1)
    with pytest.raises(ValueError) as b:
        JFleet(_step_bank("sparse_compim"), ["p0"], buckets=(32,)).set_ber(0.1)
    assert str(a.value) == str(b.value)
    assert plain.fault_config is None and not plain.ecc_stats.any()
