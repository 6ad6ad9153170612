"""AdamW with global-norm clipping, a warmup-cosine schedule and optional
low-precision optimizer state (bf16 ``m``/``v``): the port of the
reference's ``optim/adamw.py``.

Plain functions over the parameter tree (nested dicts of tensors, visited
in sorted key order as ``models/params.py`` visits them).  The update
follows the reference's arithmetic, not ``torch.optim.AdamW``'s: the
gradients are clipped in float32 and cast back to their dtype, the moments
and the step are computed in float32, ``delta = mhat / (sqrt(vhat) + eps)
+ wd * p``, and ``m``/``v`` are stored in ``state_dtype``.  Unlike the
reference, which returns new trees, ``apply_updates`` writes the
parameters and the state in place; ``step`` is an int32 scalar on the
state's device, so a step reads nothing back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.device import resolve_device
from repro_torch.models.params import flatten, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # "bfloat16" for 100B+ models
    accum_steps: int = 1              # microbatch gradient accumulation


def schedule(opt: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``opt.lr``, then a cosine to 0 at ``total_steps``
    (float32, on ``step``'s device)."""
    warm = torch.clamp(step / max(opt.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0)
    return opt.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def init_state(params: Any, opt: OptConfig, device=None) -> dict:
    """Zero moments of ``opt.state_dtype`` shaped and placed as ``params``
    (a parameter's DTensor placement kept: each rank holds its moments'
    shards) and a zero int32 step (replicated on a mesh), on ``device``
    (default: the card; raises without one unless ``device="cpu"``), which
    must be the parameters' device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:     # "cuda": the current card
        dev = torch.device("cuda", torch.cuda.current_device())
    for k, p in flatten(params).items():
        if p.device != dev:
            raise ValueError(f"parameter {k} lies on {p.device}, the optimizer state "
                             f"would lie on {dev}")
    sdt = getattr(torch, opt.state_dtype)

    def zeros(p):
        return torch.zeros_like(p, dtype=sdt, memory_format=torch.contiguous_format)

    step = torch.zeros((), dtype=torch.int32, device=dev)
    some = next(iter(flatten(params).values()), None)
    if isinstance(some, DTensor):
        step = distribute_tensor(step, some.device_mesh, [Replicate()] * some.device_mesh.ndim,
                                 src_data_rank=None)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": step}


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / global norm) in float32 and
    cast back to its dtype -> (clipped tree, the float32 global norm).  A
    sharded gradient's sum of squares is reduced over its shards (the
    norm is a replicated scalar)."""
    sq = sum(torch.sum(torch.square(g.float())) for g in flatten(grads).values())
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict, opt: OptConfig
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step: clip, advance ``step``, update each parameter and its
    moments in place -> (params, state, {"grad_norm", "lr"}), the same
    trees that came in."""
    grads, gnorm = clip_by_global_norm(grads, opt.clip_norm)
    state["step"].add_(1)
    step = state["step"]
    lr = schedule(opt, step)
    b1, b2 = opt.b1, opt.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    flat_g, flat_m, flat_v = flatten(grads), flatten(state["m"]), flatten(state["v"])
    for k, p in flatten(params).items():
        g32 = flat_g[k].float()
        m32 = b1 * flat_m[k].float() + (1 - b1) * g32
        v32 = b2 * flat_v[k].float() + (1 - b2) * torch.square(g32)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + opt.eps) + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        flat_m[k].copy_(m32)
        flat_v[k].copy_(v32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
