"""The port's hardware energy/area model held against ``repro.core.hwmodel``.

The codebooks are drawn by the reference and transferred (positions for
the sparse variants, packed words for dense), so both packages simulate the
same datapath on the same codes.

Tolerances: area inventories and toggle counts must be exactly equal (the
inventory is the same float arithmetic on the same integers; toggles are
integer sums turned into the same float32 mean).  Energies, reports and
calibration factors within a relative 1e-9: the float64 sums of the same
float32 toggle means, summed in the same order, so in practice equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import classifier as j_classifier
from repro.core import hwmodel as j_hw
from repro.core import im as j_im
from repro_torch.core import hv
from repro_torch.core import hwmodel
from repro_torch.core.classifier import HDCConfig
from repro_torch.core.im import DenseIMParams, IMParams

jax.config.update("jax_platform_name", "cpu")

SMALL = dict(dim=256, channels=8, window=32, segments=8, spatial_threshold=1,
             temporal_threshold=4)
REL = 1e-9


def _cfgs(**kw):
    return j_classifier.HDCConfig(**kw), HDCConfig(**kw)


def _params(jcfg):
    """Reference codebooks and their port copies: (sparse, dense) each."""
    jp = j_classifier.init_params(jax.random.PRNGKey(42), jcfg)
    jd = j_im.make_dense_im(jax.random.PRNGKey(7), channels=jcfg.channels,
                            codes=jcfg.codes, dim=jcfg.dim)
    tp = IMParams(torch.from_numpy(np.array(jp.item_pos, np.uint8)),
                  torch.from_numpy(np.array(jp.elec_pos, np.uint8)),
                  jcfg.dim, jcfg.segments).with_packed(True)
    td = DenseIMParams(torch.from_numpy(hv.to_i32(np.asarray(jd.item_packed))),
                       torch.from_numpy(hv.to_i32(np.asarray(jd.elec_packed))),
                       jcfg.dim)
    return (jp, jd), (tp, td)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = _cfgs(**SMALL)
    (jp, jd), (tp, td) = _params(jcfg)
    codes = np.random.default_rng(3).integers(0, 64, (4 * 32, 8), np.uint8)
    return jcfg, tcfg, (jp, jd), (tp, td), codes


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("variant", hwmodel.VARIANTS)
@pytest.mark.parametrize("geometry", [SMALL, {}], ids=["small", "paper"])
def test_area_inventory_equals_reference(variant, geometry):
    jcfg, tcfg = _cfgs(**geometry)
    assert hwmodel.area_inventory(variant, tcfg) == j_hw.area_inventory(variant, jcfg)


def test_toggle_counts_equal_exactly():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (50, 3, 8), np.uint64).astype(np.uint32)
    small = rng.integers(0, 300, (50, 5), np.int32)
    assert float(hwmodel._toggles_packed(torch.from_numpy(hv.to_i32(words)))) == \
        float(j_hw._toggles_packed(jnp.asarray(words)))
    for bits in (3, 7, 9):
        assert float(hwmodel._toggles_uint(torch.from_numpy(small), bits)) == \
            float(j_hw._toggles_uint(jnp.asarray(small), bits))


@pytest.mark.parametrize("variant", hwmodel.VARIANTS)
def test_signals_equal_reference(small, variant):
    """Every per-cycle trace of the switching simulation, bit for bit."""
    jcfg, tcfg, (jp, jd), (tp, td), codes = small
    if variant == "dense":
        want = j_hw._dense_signals(jd, jnp.asarray(codes), jcfg)
        got = hwmodel._dense_signals(td, torch.from_numpy(codes), tcfg)
    else:
        want = j_hw._sparse_signals(jp, jnp.asarray(codes), jcfg, variant)
        got = hwmodel._sparse_signals(tp, torch.from_numpy(codes), tcfg, variant)
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        g = got[k].numpy()
        w = np.asarray(w)
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)


@pytest.mark.parametrize("variant", hwmodel.VARIANTS)
def test_energy_and_report_equal_reference(small, variant):
    jcfg, tcfg, (jp, jd), (tp, td), codes = small
    jparams, tparams = (jd, td) if variant == "dense" else (jp, tp)
    want = j_hw.energy_per_prediction(variant, jparams, jnp.asarray(codes), jcfg)
    got = hwmodel.energy_per_prediction(variant, tparams, codes, tcfg)
    assert set(got) == set(want)
    for k in want:
        assert _close(got[k], want[k]), (k, got[k], want[k])
    jr = j_hw.report(variant, jparams, jnp.asarray(codes), jcfg, e_scale=1.3,
                     a_scale=0.7)
    tr = hwmodel.report(variant, tparams, codes, tcfg, e_scale=1.3, a_scale=0.7)
    assert tr["variant"] == jr["variant"]
    for key in ("area_total_mm2", "energy_total_nj", "latency_us_at_10mhz",
                "energy_per_channel_nj"):
        assert _close(tr[key], jr[key]), key
    for key in ("area_um2", "energy_nj", "energy_breakdown", "area_breakdown"):
        assert set(tr[key]) == set(jr[key])
        for m in jr[key]:
            assert _close(tr[key][m], jr[key][m]), (key, m)


def test_calibration_factors_equal_reference(small):
    jcfg, tcfg, (jp, _), (tp, _), codes = small
    want = j_hw.calibration_factors(jp, jnp.asarray(codes), jcfg)
    got = hwmodel.calibration_factors(tp, codes, tcfg)
    assert all(_close(g, w) for g, w in zip(got, want))


def test_single_frame_stream_takes_the_fixed_am_toggle(small):
    """One frame: no frame-to-frame toggles, the reference's D/4 stands in."""
    jcfg, tcfg, (jp, _), (tp, _), codes = small
    want = j_hw.energy_per_prediction("sparse_opt", jp, jnp.asarray(codes[:32]), jcfg)
    got = hwmodel.energy_per_prediction("sparse_opt", tp, codes[:32], tcfg)
    assert all(_close(got[k], want[k]) for k in want)


def test_params_device_sets_where_the_simulation_runs(small):
    """The codes move to the params' device; here the CPU."""
    _, tcfg, _, (tp, td), codes = small
    e = hwmodel.energy_per_prediction("dense", td, torch.from_numpy(codes), tcfg)
    assert e == hwmodel.energy_per_prediction("dense", td, codes, tcfg)
    assert dataclasses.is_dataclass(tp) and tp.device.type == "cpu"
