"""The port's optimizer, gradient compression and host data pipeline held
against the JAX package on the CPU: ``schedule``, ``clip_by_global_norm``
and ``apply_updates`` (float32 and bf16 optimizer state), the int8
error-feedback ``compress_decompress`` carried over 5 steps,
``host_slice`` and the ``Prefetcher``.

Inputs are drawn with numpy from a seed and fed to both packages.

Tolerances: ``compress_decompress`` (dequantised gradients and the bf16
residual) and ``host_slice`` bit for bit; ``schedule`` within 1e-6 of
``lr`` (XLA's and torch's cosines differ in the last bit); the global norm
``rtol=1e-6`` (the sums run in another order); the clipped gradients, the
parameters and the moments after each of two updates ``rtol=1e-6,
atol=1e-9`` (XLA may fuse a multiply-add that torch rounds twice: the
moments differ in their last bit on some elements), bf16 moments within
one bf16 rounding (``rtol=2**-7``).
"""

import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import pipeline as j_pipeline
from repro.optim import adamw as j_adamw
from repro.optim import compress as j_compress
from repro_torch.data import pipeline
from repro_torch.models import params
from repro_torch.optim import adamw, compress

jax.config.update("jax_platform_name", "cpu")

SHAPES = {"a": (37, 5), "b": {"c": (64,), "d": (3, 4, 5)}}


def _draw(rng, scale: float = 1.0, dtype=np.float32) -> dict:
    return params.tree_map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32).astype(dtype), SHAPES)


def _torch(tree, dtype=None):
    def one(a):
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        return t.to(dtype) if dtype is not None else t
    return params.tree_map(one, tree)


def _flat_np(tree) -> dict:
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in params.flatten(tree).items()}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_schedule_matches_reference():
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=50)
    steps = np.arange(0, 60, dtype=np.int32)
    want = np.asarray(j_adamw.schedule(j_adamw.OptConfig(**kw), jnp.asarray(steps)))
    got = adamw.schedule(adamw.OptConfig(**kw), torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * kw["lr"])
    assert got[0] == 0 and got[10] == np.float32(kw["lr"]) and got[55] == 0


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_by_global_norm_matches_reference(gdtype, scale):
    """Below the limit nothing changes; above it every leaf is scaled in
    float32 and cast back to its dtype."""
    npd = np.float32 if gdtype == "float32" else ml_dtypes.bfloat16
    g = _draw(np.random.default_rng(0), scale, npd)
    jg, jn = j_adamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = adamw.clip_by_global_norm(_torch(g, getattr(torch, gdtype)), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    want = _flat_np(jax.tree.map(np.asarray, jg))
    for k, v in params.flatten(tg).items():
        assert v.dtype == getattr(torch, gdtype)
        tol = 1e-6 if gdtype == "float32" else 2 ** -7
        np.testing.assert_allclose(v.float().numpy(), want[k], rtol=tol, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_two_steps_match_reference(state_dtype):
    """Two AdamW updates on given gradients (the first clipped): the
    parameters in place, the moments in ``state_dtype``, ``step`` an int32
    scalar, and the returned grad norm and learning rate."""
    kw = dict(warmup_steps=1, total_steps=10, state_dtype=state_dtype, clip_norm=5.0)
    jopt, topt = j_adamw.OptConfig(**kw), adamw.OptConfig(**kw)
    rng = np.random.default_rng(1)
    p = _draw(rng)
    jp, js = jax.tree.map(jnp.asarray, p), j_adamw.init_state(p, jopt)
    tp = _torch(p)
    ts = adamw.init_state(tp, topt, device="cpu")
    ids = {k: v.data_ptr() for k, v in params.flatten(tp).items()}
    for i, gscale in enumerate((3.0, 0.3)):
        g = _draw(rng, gscale)
        jp, js, jm = j_adamw.apply_updates(jp, jax.tree.map(jnp.asarray, g), js, jopt)
        tp2, ts, tm = adamw.apply_updates(tp, _torch(g), ts, topt)
        assert tp2 is tp and {k: v.data_ptr() for k, v in params.flatten(tp).items()} == ids
        assert ts["step"].dtype == torch.int32 and int(ts["step"]) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        mtol = 1e-6 if state_dtype == "float32" else 2 ** -7
        for name, got, want, rtol in (("p", tp, jp, 1e-6), ("m", ts["m"], js["m"], mtol),
                                      ("v", ts["v"], js["v"], mtol)):
            want = _flat_np(jax.tree.map(np.asarray, want))
            for k, v in params.flatten(got).items():
                assert v.dtype == (torch.float32 if name == "p" else getattr(torch, state_dtype))
                np.testing.assert_allclose(v.float().numpy(), want[k], rtol=rtol, atol=1e-9,
                                           err_msg=f"step {i} {name} {k}")


def test_init_state_refuses_parameters_elsewhere():
    tp = _torch(_draw(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="lies on"):
        adamw.init_state(tp, adamw.OptConfig(), device="meta")


@pytest.mark.parametrize("gdtype", ["float32", "bfloat16"])
def test_compress_decompress_bit_equal_over_five_steps(gdtype):
    """Per-tensor int8 at scale max|g| / 127 (round half to even), the
    residual carried in bf16: the dequantised gradients and the residual
    equal the reference's bit for bit at every step, across six decades of
    gradient scale."""
    npd = np.float32 if gdtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(2)
    jr = j_compress.init_residual(jax.tree.map(jnp.asarray, _draw(rng)))
    tr = compress.init_residual(_torch(_draw(rng)))
    assert all(v.dtype == torch.bfloat16 for v in params.flatten(tr).values())
    for step in range(5):
        g = _draw(rng, 10.0 ** rng.uniform(-4, 2), npd)
        jd, jr = j_compress.compress_decompress(jax.tree.map(jnp.asarray, g), jr)
        td, tr = compress.compress_decompress(_torch(g, getattr(torch, gdtype)), tr)
        for name, got, want in (("deq", td, jd), ("residual", tr, jr)):
            want = _flat_np(jax.tree.map(np.asarray, want))
            for k, v in params.flatten(got).items():
                assert np.array_equal(_bits(v.float().numpy()), _bits(want[k])), \
                    (step, name, k)


def test_compress_rounds_half_to_even():
    """A gradient whose quantised values land on x.5 takes the even
    neighbour, as ``jnp.round`` does."""
    g = {"g": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32)}
    deq, _ = compress.compress_decompress(_torch(g), compress.init_residual(_torch(g)))
    np.testing.assert_array_equal(deq["g"].numpy(), [127.0, 0.0, 2.0, 2.0, 0.0, -2.0])


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def _global_batch():
    rng = np.random.default_rng(3)
    return {"tokens": rng.integers(0, 100, (8, 5)).astype(np.int32),
            "frames": rng.standard_normal((8, 3, 4), np.float32)}


@pytest.mark.parametrize("index,count", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_host_slice_matches_reference(index, count):
    b = _global_batch()
    want = j_pipeline.host_slice(b, process_index=index, process_count=count)
    got = pipeline.host_slice({k: torch.from_numpy(v) for k, v in b.items()},
                              process_index=index, process_count=count)
    for k in b:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_host_slice_takes_torch_distributed_rank(monkeypatch):
    """Without arguments: the whole batch outside a process group, and the
    rank's slice of the world inside one."""
    b = {k: torch.from_numpy(v) for k, v in _global_batch().items()}
    assert torch.equal(pipeline.host_slice(b)["tokens"], b["tokens"])
    monkeypatch.setattr(pipeline.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pipeline.dist, "get_rank", lambda: 1)
    monkeypatch.setattr(pipeline.dist, "get_world_size", lambda: 4)
    assert torch.equal(pipeline.host_slice(b)["tokens"], b["tokens"][2:4])


def test_prefetcher_yields_every_step_in_order():
    made = []

    def make(step):
        made.append(threading.current_thread().name)
        return {"x": torch.full((2,), step)}

    pf = pipeline.Prefetcher(make, 3, 11, depth=2)
    got = [(s, int(b["x"][0])) for s, b in pf]
    assert got == [(s, s) for s in range(3, 11)]
    assert threading.current_thread().name not in made     # made on the worker


def test_prefetcher_stays_depth_ahead_and_closes():
    """The worker runs at most ``depth`` batches ahead of the consumer (one
    more in its hand); ``close`` stops it."""
    made = []
    pf = pipeline.Prefetcher(lambda s: made.append(s) or {"s": s}, 0, 1000, depth=2)
    it = iter(pf)
    assert next(it)[0] == 0
    time.sleep(0.2)
    assert len(made) <= 4
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert len(made) < 1000


def test_prefetcher_raises_a_failed_batch():
    def make(step):
        if step == 2:
            raise ValueError("bad step")
        return {"s": step}

    pf = pipeline.Prefetcher(make, 0, 5)
    it = iter(pf)
    assert [next(it)[0], next(it)[0]] == [0, 1]
    with pytest.raises(ValueError, match="bad step"):
        next(it)
