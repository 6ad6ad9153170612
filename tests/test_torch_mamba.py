"""The port's Mamba-1 layer (``repro_torch.models.mamba``) held against the
JAX package's ``models/mamba.py`` on the CPU: the SSM inputs (with and
without the padding mask), the causal conv, prefill at one chunk and at
two chunks with a padded tail, and the decode step; the doubling scan
against a float64 time loop; a prompt too short for the conv tail.

Weights are the reference's (``P.initialize(jax.random.PRNGKey(seed),
mamba_spec(cfg), float32)``) carried across as numpy arrays, inputs drawn
with numpy.  The reduced falcon-mamba-7b config: d_model 64, d_inner 128,
ssm_state 8, dt_rank 4, conv 4.

Tolerances (float32): the SSM inputs, the conv, the conv tail and the
outputs ``rtol=1e-4, atol=1e-4``; the SSM state ``rtol=1e-3, atol=2e-4``
(the doubling scan rounds in another order than XLA's associative scan, as
the reference's own test allows for "fp32 scan reassociation"); the scan
against the float64 loop ``rtol=1e-5, atol=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import mamba as j_mb
from repro.models import params as j_params
from repro.runtime.sharding import make_ctx
from repro_torch.configs import registry
from repro_torch.models import mamba, params

jax.config.update("jax_platform_name", "cpu")

CTX = make_ctx(None)
ARCH = "falcon-mamba-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-3, atol=2e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(seed: int = 0):
    jc = j_registry.get_config(ARCH).reduced()
    tc = registry.get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, j_params.initialize(
        jax.random.PRNGKey(seed), j_mb.mamba_spec(jc), jnp.float32))
    return jc, tc, tree, params.tree_map(_t, tree)


def _x(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_ssm_inputs_match_reference(masked):
    """``da``, ``dbx`` and ``c`` of post-conv activations; with a mask the
    masked steps pass the state through (da = 1, dbx = 0)."""
    jc, tc, jw, tw = _setup()
    xc = _x((2, 13, jc.d_inner)) * 0.5
    mask = (np.arange(13) < 9).astype(np.float32) if masked else None
    got = mamba._ssm_inputs(tw, _t(xc), tc, None if mask is None else _t(mask))
    want = j_mb._ssm_inputs(jw, xc, jc, mask=mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    if masked:
        np.testing.assert_array_equal(_np(got[0])[:, 9:], 1.0)
        np.testing.assert_array_equal(_np(got[1])[:, 9:], 0.0)


def test_conv_train_matches_reference():
    jc, tc, jw, tw = _setup()
    x = _x((2, 11, jc.d_inner))
    got = mamba._conv_train(tw, _t(x), jc.ssm_conv)
    np.testing.assert_allclose(_np(got), np.asarray(j_mb._conv_train(jw, x, jc.ssm_conv)),
                               **TOL)


@pytest.mark.parametrize("length", [21, 300])
def test_mamba_prefill_matches_reference(length):
    """Output, SSM state and conv tail; at L = 300 the scan runs a chunk of
    256 and a second one with 212 padded steps, so the carry across chunks
    and the dt = 0 mask are both on the path."""
    jc, tc, jw, tw = _setup()
    x = _x((2, length, jc.d_model))
    got, gs = mamba.mamba_prefill(tw, _t(x), tc)
    want, ws = j_mb.mamba_prefill(jw, x, jc, CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(gs["ssm"]), np.asarray(ws["ssm"]), **STATE_TOL)
    np.testing.assert_allclose(_np(gs["conv"]), np.asarray(ws["conv"]), **TOL)
    assert gs["ssm"].dtype == torch.float32
    assert tuple(gs["conv"].shape) == (2, jc.ssm_conv - 1, jc.d_inner)


def test_mamba_decode_matches_reference():
    """Three decode steps from the reference's prefill state: each output
    and the state after it."""
    jc, tc, jw, tw = _setup(seed=2)
    _, ws = j_mb.mamba_prefill(jw, _x((2, 9, jc.d_model)), jc, CTX)
    gs = {k: _t(v) for k, v in ws.items()}
    for i in range(3):
        x1 = _x((2, 1, jc.d_model), seed=10 + i)
        got, gs = mamba.mamba_decode(tw, _t(x1), gs, tc)
        want, ws = j_mb.mamba_decode(jw, x1, ws, jc, CTX)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL, err_msg=f"step {i}")
        np.testing.assert_allclose(_np(gs["ssm"]), np.asarray(ws["ssm"]), **STATE_TOL)
        np.testing.assert_allclose(_np(gs["conv"]), np.asarray(ws["conv"]), **TOL)
    init = mamba.mamba_init_state(tc, 2, torch.float32, device="cpu")
    want = j_mb.mamba_init_state(jc, 2, jnp.float32)
    for k in ("ssm", "conv"):
        assert tuple(init[k].shape) == want[k].shape and not init[k].any()
        assert init[k].device.type == "cpu"


@pytest.mark.parametrize("q", [1, 7, 256])
def test_chunk_scan_matches_a_float64_time_loop(q):
    """The doubling scan's (cumulative da, h) against h_t = da_t h_{t-1} +
    dbx_t stepped in float64; da spans the decays of the reference's init
    (exp(-e dt) for dt from 0.05 to 5)."""
    rng = np.random.default_rng(q)
    da = np.exp(-np.e * rng.uniform(0.05, 5.0, (2, q, 6, 4))).astype(np.float32)
    dbx = rng.standard_normal((2, q, 6, 4)).astype(np.float32)
    cum, h = mamba._chunk_scan(_t(da), _t(dbx))
    want_h, want_cum = np.zeros_like(dbx, np.float64), np.zeros_like(da, np.float64)
    hh, cc = np.zeros((2, 6, 4)), np.ones((2, 6, 4))
    for t in range(q):
        hh = da[:, t].astype(np.float64) * hh + dbx[:, t]
        cc = cc * da[:, t]
        want_h[:, t], want_cum[:, t] = hh, cc
    np.testing.assert_allclose(_np(h), want_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(cum), want_cum, rtol=1e-5, atol=1e-6)


def test_prompt_shorter_than_the_conv_tail_raises():
    """The reference cannot slice a conv tail of k - 1 = 3 positions from a
    2-position prompt; the port says why instead.  Three positions serve."""
    _, tc, _, tw = _setup()
    with pytest.raises(ValueError, match="ssm_conv - 1 = 3"):
        mamba.mamba_prefill(tw, torch.zeros(1, 2, tc.d_model), tc)
    _, st = mamba.mamba_prefill(tw, torch.zeros(1, 3, tc.d_model), tc)
    assert tuple(st["conv"].shape) == (1, 3, tc.d_inner)
