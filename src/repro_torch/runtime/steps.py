"""Step builders: the train step and the serving steps (prefill, decode),
and the shardings of their inputs (port of ``repro.runtime.steps``).

The reference jit-compiles each step with explicit input and output
shardings.  The port compiles nothing: its steps are plain functions with
the config bound, and on a mesh (``jit_train_step``, ``jit_prefill``,
``jit_decode_step``) they place the parameters, the optimizer state, the
batch and the caches by their shardings (DTensor placements,
``runtime/sharding.py``) before they run; an input already placed so is
used as it is.  The train step takes its gradients from autograd over the
parameter tree's leaves and updates the parameters and the optimizer state
in place (``optim/adamw.py``).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.data.pipeline import shard_to_devices
from repro_torch.models import model as model_mod
from repro_torch.models import serve as serve_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import flatten, tree_map
from repro_torch.models.serve import cache_shardings
from repro_torch.optim import adamw, compress
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import (ShardCtx, make_ctx, sharding_for,
                                          tree_shardings)

# ---------------------------------------------------------------------------
# sharding trees for non-param step inputs
# ---------------------------------------------------------------------------

def batch_shardings(batch_tree: dict, ctx: ShardCtx) -> dict:
    """A batch's ``Sharding``s by leaf name (None leaves without a mesh):
    tokens and labels ("batch", None), media and frames ("batch", None,
    None), ``pos`` replicated, any other leaf its first dim on "batch"."""
    def one(name, leaf):
        axes = {"tokens": ("batch", None), "labels": ("batch", None),
                "media": ("batch", None, None), "frames": ("batch", None, None),
                "pos": ()}.get(name)
        if axes is None:
            axes = ("batch",) + (None,) * (len(leaf.shape) - 1)
        return sharding_for(axes, ctx, tuple(leaf.shape))
    return {k: one(k, v) for k, v in batch_tree.items()}


def opt_state_shardings(spec_tree: Any, ctx: ShardCtx) -> dict:
    """The AdamW state's: each moment as its parameter, ``step``
    replicated."""
    ps = tree_shardings(spec_tree, ctx)
    return {"m": ps, "v": ps, "step": sharding_for((), ctx, ())}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _value_and_grad(params: dict, batch: dict, cfg: ArchConfig, ctx=None):
    """(loss, metrics, gradients shaped as ``params``) of ``loss_fn``: each
    leaf is taken as a fresh tensor that records a gradient (the weights
    themselves are not marked), and a leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it.  On a mesh the backward runs
    in the forward's ``replicated`` scope, and each gradient comes back
    placed as its parameter (the reduce-scatter the reference's
    partitioner makes for its ``out_shardings``)."""
    with torch.enable_grad(), shd.replicated(ctx):
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model_mod.loss_fn(tracked, batch, cfg, ctx)
        leaves = list(flatten(tracked).values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _placed_as(g, p)
                 for g, p in zip(grads, leaves)]
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` with ``p``'s placements (itself off a mesh)."""
    if not hasattr(p, "placements"):
        return g
    return shd.place(g, shd.Sharding(p.device_mesh, tuple(p.placements)))


def make_train_step(cfg: ArchConfig, opt: adamw.OptConfig,
                    grad_compress: bool = False, ctx: ShardCtx | None = None) -> Callable:
    """-> ``train_step(params, opt_state, batch[, residual])`` returning
    ``(params, opt_state[, residual], loss, metrics)``; the metrics are
    ``xent``, ``aux``, ``grad_norm`` and ``lr`` (device scalars; on a mesh
    ``ctx``, replicated DTensors, and the inputs must be placed already:
    ``jit_train_step`` places them).

    Gradient accumulation: ``opt.accum_steps`` microbatches (contiguous
    slices of the batch's leading axis) one after the other, their losses
    and gradients summed in float32 as ``g / n``, the metrics' ``aux`` 0,
    as the reference's scan.  With one microbatch the gradients keep the
    parameters' dtype."""

    def compute_grads(params, batch):
        if opt.accum_steps <= 1:
            return _value_and_grad(params, batch, cfg, ctx)
        n = opt.accum_steps
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        loss = shd.zeros((), (), ctx, dtype=torch.float32, device=batch["tokens"].device)
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
            mloss, _, g = _value_and_grad(params, mb, cfg, ctx)
            loss = loss + mloss / n
            grads = tree_map(lambda a, gi: a + gi / n, grads, g)
        return loss, {"xent": loss, "aux": torch.zeros_like(loss)}, grads

    if grad_compress:
        def train_step(params, opt_state, batch, residual):
            loss, metrics, grads = compute_grads(params, batch)
            with shd.replicated(ctx):
                grads, residual = compress.compress_decompress(grads, residual)
                params, opt_state, om = adamw.apply_updates(params, grads, opt_state, opt)
            return params, opt_state, residual, loss, {**metrics, **om}
    else:
        def train_step(params, opt_state, batch):
            loss, metrics, grads = compute_grads(params, batch)
            with shd.replicated(ctx):
                params, opt_state, om = adamw.apply_updates(params, grads, opt_state, opt)
            return params, opt_state, loss, {**metrics, **om}
    return train_step


def jit_train_step(cfg: ArchConfig, opt: adamw.OptConfig, mesh, batch_specs: dict,
                   grad_compress: bool = False):
    """The reference's ``jit_train_step``: -> ``(step, ctx, spec)``.
    Nothing is compiled: on a mesh ``step`` places the parameters (and the
    residual) by ``tree_shardings``, the optimizer state by
    ``opt_state_shardings`` and the batch by ``batch_shardings`` of
    ``batch_specs`` (a batch or shape stand-ins), then runs
    ``make_train_step``'s step; without one it is that step."""
    ctx = make_ctx(mesh)
    spec = model_mod.model_spec(cfg)
    step = make_train_step(cfg, opt, grad_compress, ctx)
    if mesh is None:
        return step, ctx, spec
    p_shard = tree_shardings(spec, ctx)
    o_shard = opt_state_shardings(spec, ctx)
    b_shard = batch_shardings(batch_specs, ctx)

    def placed_step(params, opt_state, batch, *residual):
        params = tree_map(shd.place, params, p_shard)
        opt_state = tree_map(shd.place, opt_state, o_shard)
        residual = tuple(tree_map(shd.place, r, p_shard) for r in residual)
        return step(params, opt_state, shard_to_devices(batch, b_shard), *residual)

    return placed_step, ctx, spec


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def make_prefill(cfg: ArchConfig, cache_seq: int, ctx: ShardCtx | None = None) -> Callable:
    """prefill(params, batch) -> (last-position logits (B, V), caches)."""
    def prefill(params: dict, batch: dict):
        return serve_mod.prefill(params, batch, cfg, cache_seq, ctx)
    return prefill


def make_decode_step(cfg: ArchConfig, ctx: ShardCtx | None = None) -> Callable:
    """decode_step(params, tokens, caches, pos) -> (logits (B, V), caches)."""
    def decode_step(params: dict, tokens, caches: dict, pos: int):
        return serve_mod.decode_step(params, tokens, caches, pos, cfg, ctx)
    return decode_step


def jit_prefill(cfg: ArchConfig, mesh, batch_specs: dict, cache_seq: int, *,
                seq_sharded_kv: bool = False):
    """The reference's ``jit_prefill``: -> ``(prefill, ctx, spec)``.
    Nothing is compiled: on a mesh ``prefill(params, batch)`` places the
    parameters by ``tree_shardings`` and the batch by ``batch_shardings``
    of ``batch_specs``, then runs ``models/serve.py::prefill``."""
    ctx = make_ctx(mesh, seq_sharded_kv=seq_sharded_kv)
    spec = model_mod.model_spec(cfg)
    fn = make_prefill(cfg, cache_seq, ctx)
    if mesh is None:
        return fn, ctx, spec
    p_shard = tree_shardings(spec, ctx)
    b_shard = batch_shardings(batch_specs, ctx)

    def placed_prefill(params, batch):
        return fn(tree_map(shd.place, params, p_shard), shard_to_devices(batch, b_shard))

    return placed_prefill, ctx, spec


def jit_decode_step(cfg: ArchConfig, mesh, decode_specs: dict, *,
                    seq_sharded_kv: bool = False):
    """The reference's ``jit_decode_step`` (``decode_specs``: {"tokens",
    "caches"}, tensors or shape stand-ins): -> ``(decode, ctx, spec)``.
    Nothing is compiled: on a mesh ``decode(params, tokens, caches, pos)``
    places the parameters by ``tree_shardings``, the tokens on ("batch",
    None) and the caches by ``cache_shardings`` (caches placed so already
    are written in place), then runs ``models/serve.py::decode_step``."""
    ctx = make_ctx(mesh, seq_sharded_kv=seq_sharded_kv)
    spec = model_mod.model_spec(cfg)
    fn = make_decode_step(cfg, ctx)
    if mesh is None:
        return fn, ctx, spec
    p_shard = tree_shardings(spec, ctx)
    t_shard = sharding_for(("batch", None), ctx, tuple(decode_specs["tokens"].shape))
    c_shard = cache_shardings(decode_specs["caches"], ctx)

    def placed_decode(params, tokens, caches, pos):
        return fn(tree_map(shd.place, params, p_shard), shd.place(tokens, t_shard),
                  tree_map(shd.place, caches, c_shard), pos)

    return placed_decode, ctx, spec
