"""The port's LM training path held against the JAX package on the CPU:
``loss_fn`` and its gradients (``jax.value_and_grad``), two steps of the
train step (loss, grad norm, the parameters after each step), the
reference's whole ``make_train_step`` with one and two microbatches,
``chunked_xent`` and remat.

Weights are the reference's (``P.initialize(jax.random.PRNGKey(0),
M.model_spec(cfg), float32)``) carried across with
``convert.lm_params_from_reference``; batches are drawn with numpy and fed
to both packages.  Configs are ``reduced(attn_kv_chunk=8)``, so attention
runs several KV chunks.  The dense and VLM families are here; the MoE and
SSM families (``test_torch_lm_train_moe_ssm.py``), the hybrid
(``test_torch_lm_train_hybrid.py``), the encoder-decoder and audio
families (``test_torch_lm_train_encdec.py``) and ``mamba_train`` alone
(``test_torch_mamba_train.py``) run from their own files with this file's
helpers, to keep each file's run short.

Tolerances (float32 on both sides):

* loss, xent and aux: ``rtol=1e-5``;
* each gradient leaf: within ``GRAD_TOL`` = 1e-4 of the leaf's largest
  |value| (the summation orders differ, and the MoE's scatter sums in
  another order);
* the parameters after each step: within ``STEP_TOL`` = 1e-2 of the
  largest |update| of that leaf (an AdamW update is about ``lr`` for every
  element with a nonzero gradient, whatever the gradient's size, so a
  gradient near zero can amplify a rounding difference into a part of an
  update), the losses of both steps ``rtol=1e-5`` and their grad norms
  ``rtol=GRAD_TOL``, the gradients' own bound (ten times it at the second
  step, taken at parameters that differ already by the first's);
* ``chunked_xent``: ``rtol=1e-5`` against the reference, and against a
  float64 cross entropy;
* remat on and off, and ``ssm_checkpoint_chunks`` on and off: equal bit
  for bit (the backward recomputes the same forward).

The reference's init draws a stacked leaf without fan-in dims at
1/sqrt(layers) (ROADMAP queue 3).  Where float32 is ill-conditioned at
that scale (the one-block hybrid, the encoder-decoder), the case is run
twice: at the reference's init, both packages held against a float64 run
of the port (the port's float32 at most twice as far from it as the
reference's, over all leaves; the two within 5e-2 of each leaf), and on
the same arrays rescaled (``rescaled``: every normal-init leaf scaled to
std 1/sqrt(d_model)) that both packages then take, held at the tolerances
above.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import model as j_model
from repro.models import params as j_params
from repro.optim import adamw as j_adamw
from repro.runtime import steps as j_steps
from repro.runtime.sharding import make_ctx
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import model, params
from repro_torch.optim import adamw
from repro_torch.runtime import steps

jax.config.update("jax_platform_name", "cpu")

CTX = make_ctx(None)
GRAD_TOL = 1e-4
STEP_TOL = 1e-2
LOSS_RTOL = 1e-5
BATCH, SEQ, FRAMES = 2, 24, 40
# Adam's eps at 1e-4, not 1e-8: the update g / (|g| + eps) turns a rounding
# of a gradient near zero into a sizeable share of a whole update at 1e-8
# (0.1-0.2 of it measured on deepseek); ``apply_updates`` at the default eps
# is held on given gradients by test_torch_optim.py
OPT = dict(warmup_steps=1, total_steps=10, eps=1e-4)


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def configs(arch: str, **overrides):
    """(reference config, port config) at ``reduced(attn_kv_chunk=8)``."""
    overrides = {"attn_kv_chunk": 8, **overrides}
    return (j_registry.get_config(arch).reduced(**overrides),
            registry.get_config(arch).reduced(**overrides))


def reference_weights(jc) -> dict:
    return jax.tree.map(np.asarray, j_params.initialize(
        jax.random.PRNGKey(0), j_model.model_spec(jc), jnp.float32))


def rescaled(jc, tree: dict) -> dict:
    """The same arrays with every normal-init leaf ("normal", "small")
    scaled to std 1/sqrt(d_model) (a tenth of it for "small"): a float32-
    conditioned copy that both packages take."""
    spec = params.flatten(j_model.model_spec(jc))
    flat = params.flatten(tree)
    out = {}
    for k, a in flat.items():
        init = spec[k].init
        if init in ("normal", "small"):
            target = (0.1 if init == "small" else 1.0) / np.sqrt(jc.d_model)
            a = (a * (target / a.std())).astype(np.float32)
        out[k] = a
    return _unflatten(out)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def train_batch(cfg, seq: int = SEQ, batch: int = BATCH, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    n_media = cfg.num_media_tokens if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq - n_media)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (batch, seq - n_media)).astype(np.int32)}
    if n_media:
        out["media"] = rng.standard_normal((batch, n_media, cfg.d_model), np.float32)
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.standard_normal((batch, FRAMES, cfg.d_model), np.float32)
    return out


def _torch_batch(batch: dict, dtype=torch.float32) -> dict:
    return {k: torch.from_numpy(v) if v.dtype == np.int32 else torch.from_numpy(v).to(dtype)
            for k, v in batch.items()}


def port_grads(tc, tree: dict, batch: dict, dtype=torch.float32):
    """(loss, metrics, flat gradients) of the port at ``dtype``, on the
    weights ``convert.lm_params_from_reference`` carries across."""
    tc = dataclasses.replace(tc, dtype=str(dtype).split(".")[1])
    model_ = convert.lm_params_from_reference(tc, tree, device="cpu")
    p = params.tree_map(lambda t: t.to(dtype), model_.params())
    loss, metrics, grads = steps._value_and_grad(p, _torch_batch(batch, dtype), tc)
    return loss, metrics, params.flatten(grads)


def _leaf_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def reference_value_and_grad(jc):
    """The reference's ``jax.value_and_grad(loss_fn)``, jitted once a config."""
    return jax.jit(jax.value_and_grad(lambda p, b: j_model.loss_fn(p, b, jc, CTX),
                                      has_aux=True))


def reference_step(jc, jopt):
    """The reference's train step with one microbatch, from its parts:
    ``make_train_step``'s ``compute_grads`` is ``jax.value_and_grad`` of
    ``loss_fn`` there, then ``adamw.apply_updates`` (``src/repro/runtime/
    steps.py:74-77,98-101``).  Built so, it shares the jitted gradient of
    ``reference_value_and_grad`` and compiles the model once; the whole
    ``make_train_step`` is held in ``test_train_step_matches_reference``."""
    vg = reference_value_and_grad(jc)
    update = jax.jit(functools.partial(j_adamw.apply_updates, opt=jopt))

    def step(p, s, b):
        (loss, metrics), grads = vg(p, b)
        p, s, om = update(p, grads, s)
        return p, s, loss, {**metrics, **om}
    return step


def assert_loss_and_grads(jc, tc, tree: dict, batch: dict, *, witness: bool = False):
    """Loss, xent, aux and every gradient leaf against the reference; with
    ``witness`` the two packages' gradients within 5e-2 of each leaf's
    largest |value|, and both held against a float64 run of the port: the
    port's float32 at most twice as far from it as the reference's, over
    all leaves."""
    (jl, jm), jg = reference_value_and_grad(jc)(tree, batch)
    loss, metrics, grads = port_grads(tc, tree, batch)
    np.testing.assert_allclose(_np(loss), np.asarray(jl), rtol=LOSS_RTOL)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jm[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    jg = params.flatten(jax.tree.map(np.asarray, jg))
    assert sorted(jg) == sorted(grads)
    tol = 5e-2 if witness else GRAD_TOL
    for k, want in jg.items():
        assert _leaf_err(_np(grads[k]), want) <= tol, (k, _leaf_err(_np(grads[k]), want))
    if witness:
        g64 = port_grads(tc, tree, batch, torch.float64)[2]
        port_err = max(_leaf_err(_np(grads[k]), g64[k].numpy()) for k in jg)
        ref_err = max(_leaf_err(jg[k], g64[k].numpy()) for k in jg)
        assert port_err <= 2 * ref_err, (port_err, ref_err)


def assert_two_steps(jc, tc, tree: dict, batch: dict, opt_kw: dict | None = None, *,
                     whole_step: bool = False):
    """Two steps of the reference's train step (``reference_step``, or
    with ``whole_step`` its ``make_train_step`` jitted) against the port's
    ``make_train_step`` on the same weights and batch: loss, every metric,
    and the parameters after each step."""
    opt_kw = {**OPT, **(opt_kw or {})}
    jopt, topt = j_adamw.OptConfig(**opt_kw), adamw.OptConfig(**opt_kw)
    jstep = (jax.jit(j_steps.make_train_step(jc, jopt, CTX)) if whole_step
             else reference_step(jc, jopt))
    jp, js = jax.tree.map(jnp.asarray, tree), j_adamw.init_state(tree, jopt)
    tp = convert.lm_params_from_reference(tc, tree, device="cpu").params()
    ts = adamw.init_state(tp, topt, device="cpu")
    tstep = steps.make_train_step(tc, topt)
    tb = _torch_batch(batch)
    p0 = params.flatten(tree)
    for i in range(2):
        jp, js, jl, jm = jstep(jp, js, batch)
        tp, ts, tl, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=LOSS_RTOL, err_msg=f"step {i}")
        for k in ("xent", "aux", "grad_norm", "lr"):
            # the norm takes the gradients' own bound; at the second step the
            # parameters it is taken at differ already by the first's
            rtol = GRAD_TOL * (1 + 9 * i) if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        assert int(ts["step"]) == int(js["step"]) == i + 1
        want = params.flatten(jax.tree.map(np.asarray, jp))
        for k, got in params.flatten(tp).items():
            update = np.abs(want[k] - p0[k]).max()
            err = np.abs(_np(got) - want[k]).max()
            assert err <= STEP_TOL * max(update, 1e-12), (i, k, err, update)


def family_case(arch: str, *, family: str | None = None, ill_conditioned: bool = False):
    """The whole parity case of one family: at the reference's init the
    loss and gradients (with the float64 witness where ``ill_conditioned``)
    and, on well-conditioned weights (the reference's, or ``rescaled``
    where ``ill_conditioned``), the loss and gradients again and two train
    steps."""
    jc, tc = configs(arch, **({"family": family} if family else {}))
    tree = reference_weights(jc)
    batch = train_batch(tc)
    assert_loss_and_grads(jc, tc, tree, batch, witness=ill_conditioned)
    if ill_conditioned:
        tree = rescaled(jc, tree)
        assert_loss_and_grads(jc, tc, tree, batch)
    assert_two_steps(jc, tc, tree, batch)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-2b"])
def test_family_loss_grads_and_two_steps_match_reference(arch):
    """Dense and VLM (loss on the text positions) at the reference's init."""
    family_case(arch)


# ---------------------------------------------------------------------------
# chunked_xent
# ---------------------------------------------------------------------------

def _xent_inputs(jc, seq: int):
    rng = np.random.default_rng(seq)
    tree = reference_weights(jc)
    hidden = rng.standard_normal((2, seq, jc.d_model), np.float32)
    labels = rng.integers(0, jc.vocab, (2, seq)).astype(np.int32)
    return tree, hidden, labels


def _xent64(table: np.ndarray, hidden: np.ndarray, labels: np.ndarray) -> float:
    logits = hidden.astype(np.float64) @ table.astype(np.float64).T     # tied
    m = logits.max(-1, keepdims=True)
    logz = np.log(np.exp(logits - m).sum(-1)) + m[..., 0]
    gold = np.take_along_axis(logits, labels[..., None].astype(np.int64), -1)[..., 0]
    return float((logz - gold).mean())


@pytest.mark.parametrize("seq", [24, 512, 1024])
def test_chunked_xent_matches_reference(seq):
    """Where the reference takes every position (L <= 512, L % 512 == 0)."""
    jc, tc = configs("qwen3-0.6b")
    tree, hidden, labels = _xent_inputs(jc, seq)
    want = j_model.chunked_xent(tree, hidden, labels, jc, CTX)
    got = model.chunked_xent(params.tree_map(torch.from_numpy, tree),
                             torch.from_numpy(hidden), torch.from_numpy(labels), tc)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(got), _xent64(tree["embed"], hidden, labels),
                               rtol=LOSS_RTOL)


def test_chunked_xent_counts_the_tail_the_reference_drops():
    """L = 600: the port's loss is the cross entropy over all 600 positions;
    the reference's is over the first 512 only (its ``L // 512`` whole
    chunks; ROADMAP queue 3), and the two differ."""
    jc, tc = configs("qwen3-0.6b")
    tree, hidden, labels = _xent_inputs(jc, 600)
    got = _np(model.chunked_xent(params.tree_map(torch.from_numpy, tree),
                                 torch.from_numpy(hidden), torch.from_numpy(labels), tc))
    want = np.asarray(j_model.chunked_xent(tree, hidden, labels, jc, CTX))
    every = _xent64(tree["embed"], hidden, labels)
    head = _xent64(tree["embed"], hidden[:, :512], labels[:, :512])
    np.testing.assert_allclose(got, every, rtol=LOSS_RTOL)
    np.testing.assert_allclose(want, head, rtol=LOSS_RTOL)
    assert abs(every - head) > 10 * LOSS_RTOL * abs(every)


# ---------------------------------------------------------------------------
# remat and accumulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,flag", [("qwen3-0.6b", "remat"), ("deepseek-moe-16b", "remat"),
                                       ("falcon-mamba-7b", "remat"),
                                       ("falcon-mamba-7b", "ssm_checkpoint_chunks")])
def test_checkpointing_changes_no_gradient(arch, flag):
    """Per-layer remat (and the scan's per-chunk checkpoints) recompute the
    same forward in the backward: loss and every gradient equal bit for bit
    with the flag off."""
    jc, tc = configs(arch, ssm_chunk=8)
    tree = reference_weights(jc)
    batch = train_batch(tc)
    runs = [port_grads(dataclasses.replace(tc, **{flag: on}), tree, batch)
            for on in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for k, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][k]), k


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """The reference's whole ``make_train_step``, jitted, against the
    port's: one microbatch, and ``accum_steps = 2`` (two microbatches of 2,
    the gradients summed in float32 as g / 2, the metrics' aux 0); two
    steps of both packages."""
    jc, tc = configs("qwen3-0.6b")
    tree = reference_weights(jc)
    assert_two_steps(jc, tc, tree, train_batch(tc, batch=4), {"accum_steps": accum},
                     whole_step=True)
