"""The port's faulted fleet step held against the reference's: the
reference's ``_fleet_step`` (``backend="jnp"``) with ``faults=plan``,
``fault_ber`` and ``fault_seed`` draws its own masks; the port's
``_fleet_step`` is handed the same masks, rebuilt with the reference's own
``component_keys``, ``jax.random.split`` and ``hv.random_flip_mask``
(``faults.StepDraw``).  Cases: {transient, stuck} x {none, parity, secded}
x {``sparse_compim``, ``dense``}, and a masked thinned fleet.

Tolerance: exact equality of the state, frames, scores and ECC counts
(integer and bit arithmetic).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hv as j_hv
from repro.reliability import ecc as j_ecc
from repro.reliability import faults as j_faults
from repro.runtime.sharding import ShardCtx
from repro.serve import dispatch as j_dispatch
from repro.serve import fleet as j_fleet
from repro_torch.reliability import faults
from repro_torch.reliability.faults import FaultPlan, StepDraw, WordDraw
from repro_torch.serve import fleet as t_fleet
from repro_torch.serve.fleet import FleetState, StreamingFleet
from test_torch_online import CHANNELS, WINDOW, _chunk, _transfer
from test_torch_reliability import _banks, _step_bank, _t, _u

jax.config.update("jax_platform_name", "cpu")

def _rebuild(key, shape, ber, bits, mode) -> WordDraw:
    """The reference's draw for one target, as its ``xor_mask`` makes it."""
    def rfm(k, p):
        return _t(np.asarray(j_hv.random_flip_mask(k, shape, p, bits)))
    if mode == "transient":
        return WordDraw(rfm(key, ber))
    k_sel, k_val = jax.random.split(key)
    return WordDraw(rfm(k_sel, ber), rfm(k_val, 0.5))


def _reference_draw(plan, ber, seed, *, tables_shape, rows_shape, counts_shape,
                    window) -> StepDraw:
    k_tab, k_am, k_cnt = j_faults.component_keys(jnp.int32(seed))
    out = {}
    if plan.tables:
        out["tables"] = _rebuild(k_tab, tables_shape, ber[0], 32, plan.mode)
    if plan.am:
        k_d, k_c = jax.random.split(k_am)
        out["am"] = _rebuild(k_d, rows_shape, ber[1], 32, plan.mode)
        if plan.ecc != "none":
            out["am_check"] = _rebuild(k_c, rows_shape, ber[1],
                                       j_ecc.n_check_bits(plan.ecc), plan.mode)
    if plan.counts:
        out["counts"] = _rebuild(k_cnt, counts_shape, ber[2],
                                 faults.counter_bits(plan, window), plan.mode)
    return StepDraw(**out)


def _state_to_port(js) -> FleetState:
    return FleetState(**{
        f.name: (_t(np.asarray(getattr(js, f.name))) if f.name in ("class_rows", "last_frame")
                 else torch.from_numpy(np.asarray(getattr(js, f.name)).copy()))
        for f in dataclasses.fields(FleetState)})


# The reference's step helpers, each compiled once: the same operations as
# op-by-op dispatch, which would compile every operation of every case on
# its own and take most of this file's time.
_JITTED = [(j_fleet.fleet_ops, "fleet_counts", jax.jit(j_fleet.fleet_ops.fleet_counts,
                                                          static_argnums=(3,))),
           (j_dispatch, "owner_spatial_codes", jax.jit(j_dispatch.owner_spatial_codes,
                                                         static_argnums=(3,))),
           (j_hv, "random_flip_mask", jax.jit(j_hv.random_flip_mask, static_argnums=(1, 3))),
           (j_ecc, "encode", jax.jit(j_ecc.encode, static_argnums=(1,))),
           (j_ecc, "decode", jax.jit(j_ecc.decode, static_argnums=(2,)))]


@pytest.fixture
def jitted_reference(monkeypatch):
    for mod, name, fn in _JITTED:
        monkeypatch.setattr(mod, name, fn)


_STEP_CASES = [(v, m, e, False) for v in ("sparse_compim", "dense")
               for m in ("transient", "stuck") for e in ("none", "parity", "secded")]
_STEP_CASES.append(("thin", "stuck", "secded", True))


_STEP_OWNERS = ["p0", "p1", "p1", "p0", "p1"]


@functools.lru_cache(maxsize=None)
def _mid_stream(variant: str, masked: bool):
    """A fleet's tile after two ragged rounds, as the reference's step
    operands, and a third round's chunk: counters, fill levels and
    emissions mid-stream.  The rounds run in the port's fleet, which
    decides as the reference's (``tests/test_torch_fleet.py``,
    ``tests/test_torch_channels.py``)."""
    s = len(_STEP_OWNERS)
    jbank, tbank = _banks(variant)
    port = StreamingFleet(tbank, _STEP_OWNERS,
                          buckets=(16, 32), channel_masking=masked)
    mask = None
    if masked:
        mask = np.ones((s, CHANNELS), np.uint8)
        mask[1, :3] = 0
        mask[4, 5] = 0
        port.set_channel_mask(mask)
    rng = np.random.default_rng(5)
    for _ in range(2):
        port.push([_chunk(rng, int(t)) for t in rng.integers(0, 40, s)])
    js = j_fleet.FleetState(**{
        f.name: jnp.asarray(_u(v) if f.name in ("class_rows", "last_frame") else v.numpy())
        for f in dataclasses.fields(FleetState) for v in [getattr(port.state, f.name)]})
    lengths = np.asarray([32, 0, 17, 32, 9], np.int32)
    chunk = rng.integers(0, 64, (s, 32, CHANNELS), np.uint8)
    return (j_dispatch.validate_bank(jbank), js, jnp.asarray(_u(port._tables)),
            jnp.asarray(port._param_owner_t[0].numpy()),
            jnp.asarray(port._thresholds_t[0].numpy()), chunk, lengths, mask)


@pytest.mark.parametrize("variant,mode,scheme,masked", _STEP_CASES,
                         ids=["-".join(map(str, c)) for c in _STEP_CASES])
def test_faulted_step_matches_reference_given_its_draws(variant, mode, scheme, masked,
                                                        jitted_reference):
    """One faulted step on every target at BER 0.03: the reference's
    ``_fleet_step`` (jnp) with its own masks, and the port's with those
    masks rebuilt from the reference's keys.  The carried state comes from
    two ragged reference rounds, so counters, fill levels and emissions are
    mid-stream; state, frames, scores and ECC counts equal bit for bit."""
    jbank = _step_bank(variant)
    cfg, js, tables, owner, thr, chunk, lengths, mask = _mid_stream(variant, masked)
    fc = j_faults.FaultConfig(tables=0.03, am=0.03, counts=0.03, mode=mode,
                              seed=21, ecc=scheme)
    cm = None if mask is None else jnp.asarray(mask)
    plan = fc.plan()
    ber, seed = fc.ber_vector(), 1234
    j_state, j_out, j_ecc_c = j_fleet._fleet_step(
        js, tables, owner, thr, jnp.asarray(chunk), jnp.asarray(lengths),
        jnp.asarray(ber), jnp.int32(seed), cm, cfg=cfg, ctx=ShardCtx(None),
        use_kernel=False, faults=plan, masked=masked)

    tcfg = _transfer(next(iter(jbank.values()))).cfg
    tcfg = dataclasses.replace(tcfg, temporal_threshold=0, class_density=0.5)
    draw = _reference_draw(plan, ber, seed, tables_shape=tables.shape,
                           rows_shape=js.class_rows.shape,
                           counts_shape=js.counts.shape, window=WINDOW)
    t_state, t_out, t_ecc_c = t_fleet._fleet_step(
        _state_to_port(js), _t(np.asarray(tables)),
        torch.from_numpy(np.array(owner)), torch.from_numpy(np.array(thr)),
        torch.from_numpy(chunk), torch.from_numpy(lengths),
        None if mask is None else torch.from_numpy(mask.astype(np.int32)),
        cfg=tcfg, faults=faults.FaultPlan(**dataclasses.asdict(plan)), draw=draw)
    for f in dataclasses.fields(FleetState):
        got, want = getattr(t_state, f.name), np.asarray(getattr(j_state, f.name))
        got = _u(got) if want.dtype == np.uint32 else got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    np.testing.assert_array_equal(_u(t_out.frames), np.asarray(j_out.frames))
    np.testing.assert_array_equal(t_out.scores.numpy(), np.asarray(j_out.scores))
    np.testing.assert_array_equal(t_ecc_c.numpy(), np.asarray(j_ecc_c))
    assert t_ecc_c.dtype == torch.int32
    if scheme == "secded":
        assert t_ecc_c[:, 0].sum() > 0      # the draws landed in the AM


def test_unfaulted_step_returns_two_outputs():
    f = StreamingFleet(_banks("sparse_compim")[1], ["p0", "p1"], buckets=(32,))
    st = f._state_t[0]
    out = t_fleet._fleet_step(st, f._tables, f._param_owner_t[0], f._thresholds_t[0],
                              torch.zeros((2, 32, CHANNELS), dtype=torch.uint8),
                              torch.full((2,), 32, dtype=torch.int32), cfg=f._cfg)
    assert len(out) == 2
    out = t_fleet._fleet_step(st, f._tables, f._param_owner_t[0], f._thresholds_t[0],
                              torch.zeros((2, 32, CHANNELS), dtype=torch.uint8),
                              torch.full((2,), 32, dtype=torch.int32), cfg=f._cfg,
                              faults=FaultPlan(), draw=StepDraw())
    assert len(out) == 3 and not out[2].any() and out[2].shape == (2, 3)
