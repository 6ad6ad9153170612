"""Step builders: the train step and the serving steps (prefill, decode).

The reference jit-compiles each step with its shardings; on one card the
port's steps are plain functions with the config bound (no compile, no
sharding).  The train step takes its gradients from autograd over the
parameter tree's leaves and updates the parameters and the optimizer state
in place (``optim/adamw.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import model as model_mod
from repro_torch.models import serve as serve_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import flatten, tree_map
from repro_torch.optim import adamw, compress


def _value_and_grad(params: dict, batch: dict, cfg: ArchConfig):
    """(loss, metrics, gradients shaped as ``params``) of ``loss_fn``: each
    leaf is taken as a fresh tensor that records a gradient (the weights
    themselves are not marked), and a leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it."""
    with torch.enable_grad():
        tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model_mod.loss_fn(tracked, batch, cfg)
        leaves = list(flatten(tracked).values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg: ArchConfig, opt: adamw.OptConfig,
                    grad_compress: bool = False) -> Callable:
    """-> ``train_step(params, opt_state, batch[, residual])`` returning
    ``(params, opt_state[, residual], loss, metrics)``; the metrics are
    ``xent``, ``aux``, ``grad_norm`` and ``lr`` (device scalars).

    Gradient accumulation: ``opt.accum_steps`` microbatches (contiguous
    slices of the batch's leading axis) one after the other, their losses
    and gradients summed in float32 as ``g / n``, the metrics' ``aux`` 0,
    as the reference's scan.  With one microbatch the gradients keep the
    parameters' dtype."""

    def compute_grads(params, batch):
        if opt.accum_steps <= 1:
            return _value_and_grad(params, batch, cfg)
        n = opt.accum_steps
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
            mloss, _, g = _value_and_grad(params, mb, cfg)
            loss = loss + mloss / n
            grads = tree_map(lambda a, gi: a + gi / n, grads, g)
        return loss, {"xent": loss, "aux": torch.zeros_like(loss)}, grads

    if grad_compress:
        def train_step(params, opt_state, batch, residual):
            loss, metrics, grads = compute_grads(params, batch)
            grads, residual = compress.compress_decompress(grads, residual)
            params, opt_state, om = adamw.apply_updates(params, grads, opt_state, opt)
            return params, opt_state, residual, loss, {**metrics, **om}
    else:
        def train_step(params, opt_state, batch):
            loss, metrics, grads = compute_grads(params, batch)
            params, opt_state, om = adamw.apply_updates(params, grads, opt_state, opt)
            return params, opt_state, loss, {**metrics, **om}
    return train_step


def make_prefill(cfg: ArchConfig, cache_seq: int) -> Callable:
    """prefill(params, batch) -> (last-position logits (B, V), caches)."""
    def prefill(params: dict, batch: dict):
        return serve_mod.prefill(params, batch, cfg, cache_seq)
    return prefill


def make_decode_step(cfg: ArchConfig) -> Callable:
    """decode_step(params, tokens, caches, pos) -> (logits (B, V), caches)."""
    def decode_step(params: dict, tokens, caches: dict, pos: int):
        return serve_mod.decode_step(params, tokens, caches, pos, cfg)
    return decode_step
