"""Sharding rules: logical parameter/activation axes -> mesh placements
(port of ``repro.runtime.sharding``; the same logical axes and rules).

Logical axes used by the model zoo:

  fsdp      parameter & optimizer-state sharding axis (ZeRO-3 style)
  tp        tensor-parallel axis (attention heads, FFN hidden, experts, vocab)
  batch     data-parallel activation axis
  kv_seq    sequence axis of decode KV caches
  kv_tp     head_dim axis of decode KV caches (TP fallback when batch is wide)
  None      replicated

Rule sets (``make_ctx``):

* default             batch -> (pod, data); kv_seq unsharded; kv_tp -> model
* seq_sharded_kv      batch unsharded, kv_seq -> (pod, data): sequence
                      parallelism over the KV cache for tiny batches.

The reference maps axes to a ``PartitionSpec``, one entry a TENSOR
dimension; DTensor placements have one entry a MESH dimension.  So a
tensor dimension over ``("pod", "data")`` becomes ``Shard(d)`` on both
mesh dimensions, which DTensor splits in mesh order: pod major, data
minor, as JAX orders the names of one entry.  A mesh axis that does not
divide its dimension replicates it (``_sanitize``; e.g. 8 KV heads over a
16-way ``model`` axis), as in the reference.

The rule functions need only the axis names and sizes, no process group:
``placements_for(axes, rules, shape, axis_names, sizes)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models import params as pmod


def _base_rules(axis_names: tuple[str, ...]) -> dict:
    dp = ("pod", "data") if "pod" in axis_names else ("data",)
    return {
        "fsdp": dp,
        "tp": ("model",),
        "batch": dp,
        "kv_seq": (),
        "kv_tp": ("model",),
        "stage": ("pod",) if "pod" in axis_names else (),
    }


@dataclass(frozen=True)
class ShardCtx:
    """A mesh (``None``: no placement at all), its axis names and sizes, and
    the logical -> mesh-axis rules."""

    mesh: Any
    rules: dict = field(default_factory=dict)
    axis_names: tuple = ()
    shape: tuple = ()

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: the port's ``NamedSharding``."""

    mesh: Any
    placements: tuple


def make_ctx(mesh, *, seq_sharded_kv: bool = False) -> ShardCtx:
    if mesh is None:
        return ShardCtx(None, {})
    names = tuple(mesh.mesh_dim_names)
    return ShardCtx(mesh, rules_for(names, seq_sharded_kv=seq_sharded_kv), names,
                    tuple(mesh.shape))


def rules_for(axis_names: tuple[str, ...], *, seq_sharded_kv: bool = False) -> dict:
    """``make_ctx``'s rules from the axis names alone."""
    rules = _base_rules(tuple(axis_names))
    if seq_sharded_kv:
        rules = rules | {"batch": (), "kv_seq": rules["fsdp"], "kv_tp": ("model",)}
    return rules


def _mesh_axes(ax, rules: dict) -> tuple[str, ...]:
    """The mesh axes one tensor dimension's logical axes map to."""
    if ax is None:
        return ()
    names = (ax,) if isinstance(ax, str) else tuple(ax)
    out: list[str] = []
    for n in names:
        out.extend(rules.get(n, ()))
    return tuple(out)


def placements_for(axes: tuple, rules: dict, shape: tuple[int, ...] | None,
                   axis_names: tuple[str, ...], sizes: tuple[int, ...]
                   ) -> tuple[Placement, ...]:
    """Logical axes (one entry a tensor dim: a logical name, a tuple of
    them, or None) -> one placement a mesh dim.  With ``shape``, a tensor
    dim whose mesh axes do not divide it is replicated (``_sanitize``)."""
    size_of = dict(zip(axis_names, sizes))
    out: list[Placement] = [Replicate()] * len(axis_names)
    for d, ax in enumerate(axes):
        mesh_axes = _mesh_axes(ax, rules)
        if not mesh_axes:
            continue
        if shape is not None and shape[d] % math.prod(size_of[a] for a in mesh_axes):
            continue
        dims = [axis_names.index(a) for a in mesh_axes]
        if dims != sorted(dims):
            raise ValueError(
                f"tensor dim {d} shards over {mesh_axes}, not in mesh order "
                f"{axis_names}: a placement splits in mesh order")
        for m in dims:
            if out[m] != Replicate():
                raise ValueError(
                    f"mesh axis {axis_names[m]!r} shards two tensor dims of {axes}")
            out[m] = Shard(d)
    return tuple(out)


def sharding_for(axes: tuple, ctx: ShardCtx,
                 shape: tuple[int, ...] | None = None) -> Sharding | None:
    if ctx.mesh is None:
        return None
    return Sharding(ctx.mesh, placements_for(axes, ctx.rules, shape,
                                             ctx.axis_names, ctx.shape))


def place(x: torch.Tensor, where) -> torch.Tensor:
    """Put a full tensor where ``where`` says: a ``Sharding`` (each rank
    keeps its part of its own copy of the full tensor: no broadcast), a
    device, or None (as it is)."""
    if where is None:
        return x
    x = torch.as_tensor(x)
    if isinstance(where, Sharding):
        return distribute_tensor(x, where.mesh, list(where.placements),
                                 src_data_rank=None)
    return x.to(where)


def constrain(x: torch.Tensor, axes: tuple, ctx: ShardCtx) -> torch.Tensor:
    """Redistribute ``x`` to its logical axes' placements (the identity
    without a mesh); a plain tensor is taken as the full value."""
    sh = sharding_for(axes, ctx, tuple(x.shape))
    if sh is None:
        return x
    if isinstance(x, DTensor):
        return x.redistribute(sh.mesh, list(sh.placements))
    return place(x, sh)


def tree_shardings(spec_tree: Any, ctx: ShardCtx):
    """Map a tree of ``ParamSpec`` (models/params.py) to ``Sharding``s."""
    return pmod.tree_map(lambda s: sharding_for(s.axes, ctx, s.shape), spec_tree)


def local_rows(n: int, sharding: Sharding | None, coord: tuple[int, ...]) -> slice:
    """The rows of a length-``n`` leading dim that the rank at mesh
    coordinate ``coord`` holds under ``sharding`` (all of them when dim 0
    is replicated): the blocks of the mesh dims that shard dim 0, major
    to minor."""
    if sharding is None:
        return slice(0, n)
    dims = [m for m, p in enumerate(sharding.placements) if p == Shard(0)]
    sizes = tuple(sharding.mesh.shape)
    blocks = math.prod(sizes[m] for m in dims)
    b = 0
    for m in dims:
        b = b * sizes[m] + coord[m]
    per = n // blocks
    return slice(b * per, (b + 1) * per)
