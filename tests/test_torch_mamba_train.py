"""``mamba_train`` held against the reference's on the CPU: one mamba
layer's output and the gradients of a random projection of it (each weight
and the input), at L = 21 (chunks of 8: three, the last short) and L = 300
(chunks of 256: two, the last short), with ``ssm_checkpoint_chunks`` on
and off; and the port's train scan against its own prefill.

Tolerances (float32): the output ``rtol=1e-3, atol=2e-4``, as the serving
tests hold the scan (the doubling order rounds differently from XLA's
``associative_scan``); each gradient within 1e-3 of its largest |value|;
the train scan equal to prefill's bit for bit (the same arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as j_mamba
from repro.models import params as j_params
from repro_torch.models import mamba, params
from test_torch_lm_train import CTX, _leaf_err, _np, configs


@pytest.mark.parametrize("seq,chunk", [(21, 8), (300, 256)])
@pytest.mark.parametrize("ckpt_chunks", [False, True])
def test_mamba_train_matches_reference(seq, chunk, ckpt_chunks):
    """One mamba layer: the output and the gradients of a random projection
    of it (each weight and the input) against the reference's
    ``mamba_train``; the chunks are ``min(ssm_chunk, L)`` with a short
    tail, the carry seeded across them."""
    jc, tc = configs("falcon-mamba-7b", ssm_chunk=chunk, ssm_checkpoint_chunks=ckpt_chunks)
    rng = np.random.default_rng(seq + chunk)
    w = jax.tree.map(np.asarray, j_params.initialize(
        jax.random.PRNGKey(3), j_mamba.mamba_spec(jc), jnp.float32))
    x = rng.standard_normal((2, seq, jc.d_model), np.float32)
    proj = rng.standard_normal((2, seq, jc.d_model), np.float32)

    def j_obj(w, x):
        y = j_mamba.mamba_train(w, x, jc, CTX)
        return jnp.sum(y * proj), y

    (_, jy), (jgw, jgx) = jax.jit(jax.value_and_grad(j_obj, argnums=(0, 1),
                                                     has_aux=True))(w, x)
    tw = params.tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(), w)
    tx = torch.from_numpy(x).requires_grad_()
    ty = mamba.mamba_train(tw, tx, tc)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-3, atol=2e-4)
    leaves = list(params.flatten(tw).values()) + [tx]
    grads = torch.autograd.grad((ty * torch.from_numpy(proj)).sum(), leaves)
    want = list(params.flatten(jax.tree.map(np.asarray, jgw)).values()) + [np.asarray(jgx)]
    for k, g, jg in zip(list(params.flatten(tw)) + ["x"], grads, want):
        assert _leaf_err(_np(g), jg) <= 1e-3, (k, _leaf_err(_np(g), jg))


def test_mamba_train_scan_is_prefills_arithmetic():
    """At L = 300 (two chunks of prefill's 256, the second short) the train
    scan's output equals prefill's bit for bit: the same doubling steps,
    out of place, and prefill's masked padding changes nothing before L."""
    _, tc = configs("falcon-mamba-7b")
    w = params.initialize(torch.Generator().manual_seed(0), mamba.mamba_spec(tc),
                          torch.float32, "cpu")
    x = torch.randn((2, 300, tc.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(mamba.mamba_train(w, x, tc), mamba.mamba_prefill(w, x, tc)[0])
