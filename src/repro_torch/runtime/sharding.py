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
16-way ``model`` axis), as in the reference.  A rule's axis that the mesh
does not have shards nothing: on a one-axis ``("data",)`` mesh the
``tp`` dims replicate (the reference's ``_sanitize`` raises a KeyError
there).

The rule functions need only the axis names and sizes, no process group:
``placements_for(axes, rules, shape, axis_names, sizes)``.

Where the model code meets DTensors (the LM on a mesh):

* ``constrain(x, axes, ctx)`` is the reference's ``constrain``: a
  redistribution to the logical axes' placements, the identity without a
  mesh (``ctx`` None or mesh-less).
* ``replicated(ctx)`` scopes the plain helper tensors the model makes
  (positions, masks, zeros, frequencies): inside it a plain tensor that
  meets a DTensor is taken as ``Replicate`` on the mesh, as ``jnp``'s
  constants are replicated under ``jit``.  Every rank makes the same
  helper, so nothing is moved.
* ``local(fn, ctx, in_placements, out_placements)`` runs ``fn`` on each
  rank's shards (``local_map``), for the ops with no DTensor sharding
  strategy (stable sorts, cumulative sums, scatters, in-place cache
  writes) and the reductions the reference leaves to its partitioner
  (the vocabulary log-sum-exp, the sequence-sharded decode softmax).
  Inputs must already have their placements: ``local`` moves nothing.
* ``reshard(x, axes, ctx, why)`` is a redistribution the reference does
  not have; each call names its reason, and ``ROADMAP.md`` lists them.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

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
        # a rule's mesh axis this mesh lacks shards nothing (a one-axis
        # ("data",) mesh has no "model": tp replicates)
        mesh_axes = tuple(a for a in _mesh_axes(ax, rules) if a in size_of)
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
    """Put a tensor where ``where`` says: a ``Sharding`` (a full tensor:
    each rank keeps its part of its own copy, no broadcast; a DTensor:
    redistributed, or itself where its placements agree), a device, or
    None (as it is)."""
    if where is None:
        return x
    if isinstance(where, Sharding):
        if isinstance(x, DTensor):
            if tuple(x.placements) == tuple(where.placements):
                return x
            return x.redistribute(where.mesh, list(where.placements))
        return distribute_tensor(torch.as_tensor(x), where.mesh, list(where.placements),
                                 src_data_rank=None)
    return torch.as_tensor(x).to(where)


def on_mesh(ctx: ShardCtx | None) -> bool:
    return ctx is not None and ctx.mesh is not None


def constrain(x: torch.Tensor, axes: tuple, ctx: ShardCtx | None) -> torch.Tensor:
    """Redistribute ``x`` to its logical axes' placements (the identity
    without a mesh); a plain tensor is taken as the full value."""
    if not on_mesh(ctx):
        return x
    return place(x, sharding_for(axes, ctx, tuple(x.shape)))


def reshard(x: torch.Tensor, axes: tuple, ctx: ShardCtx | None, why: str) -> torch.Tensor:
    """``constrain`` at a site the reference does not have: ``why`` says
    what needs it (``ROADMAP.md`` lists every such site)."""
    del why
    return constrain(x, axes, ctx)


def zeros(shape: tuple[int, ...], axes: tuple, ctx: ShardCtx | None, **kw) -> torch.Tensor:
    """``torch.zeros(shape, **kw)`` placed by logical ``axes`` on ``ctx``'s
    mesh (each rank keeps its part; no collective); plain without one."""
    return constrain(torch.zeros(shape, **kw), axes, ctx)


def placements(axes: tuple, ctx: ShardCtx | None,
               shape: tuple[int, ...] | None = None) -> tuple | None:
    """The placements of logical ``axes`` (sanitised by ``shape``), None
    without a mesh."""
    sh = sharding_for(axes, ctx, shape) if on_mesh(ctx) else None
    return None if sh is None else sh.placements


@contextmanager
def replicated(ctx: ShardCtx | None) -> Iterator[None]:
    """Plain tensors meet DTensors as ``Replicate`` on ``ctx``'s mesh inside
    (the identity without a mesh).  Unlike ``implicit_replication``, it
    nests: the state before is restored on exit.  The backward of what ran
    inside must run inside too (the saved masks are plain)."""
    if not on_mesh(ctx):
        yield
        return
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def local(fn: Callable, ctx: ShardCtx | None, in_placements: tuple,
          out_placements: tuple, in_grad_placements: tuple | None = None) -> Callable:
    """``fn`` over each rank's local shards (``local_map``): one entry of
    ``in_placements`` an argument (None for a non-tensor), one of
    ``out_placements`` a returned tensor.  An input whose placements
    differ raises: ``local`` redistributes nothing.  An input replicated
    over ranks that each use it on other rows gets a partial gradient on
    each: ``in_grad_placements`` says so (``Partial`` there; default: the
    input's placements).  ``fn`` itself without a mesh."""
    if not on_mesh(ctx):
        return fn
    ins = tuple(None if p is None else list(p) for p in in_placements)
    grads = ins if in_grad_placements is None else tuple(
        None if p is None else list(p) for p in in_grad_placements)
    return local_map(fn, out_placements=tuple(list(p) for p in out_placements),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=ctx.mesh, redistribute_inputs=False)


def pad(x: torch.Tensor, widths: tuple[int, ...], ctx: ShardCtx | None) -> torch.Tensor:
    """``F.pad(x, widths)`` with zeros, on each rank's shards when ``x`` is
    a DTensor (torch 2.11's sharding rule for ``constant_pad_nd`` on a mesh
    of two or more dims plans a redistribution it cannot carry out).  No
    padded dim may be sharded; a ``Partial`` sum pads with its zeros."""
    if not (on_mesh(ctx) and isinstance(x, DTensor)):
        return torch.nn.functional.pad(x, widths)
    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    pl = tuple(x.placements)
    if any(isinstance(p, Shard) and p.dim in padded for p in pl):
        raise ValueError(f"pad: dims {sorted(padded)} of a tensor placed {pl} are sharded")
    return local(lambda t: torch.nn.functional.pad(t, widths), ctx, (pl,), (pl,))(x)


def partial_where(placements_: tuple, users: tuple, dim: int) -> tuple:
    """``placements_`` with ``Partial()`` on each mesh dim where ``users``
    (another input's placements) shards tensor dim ``dim``: the gradient
    of an input replicated there is a partial sum on each rank."""
    return tuple(Partial() if u == Shard(dim) else p for p, u in zip(placements_, users))


def shard_block(placements_: tuple, dim: int, ctx: ShardCtx) -> tuple[int, list[str]]:
    """The mesh axes whose placements shard tensor dim ``dim`` and this
    rank's block of that dim along them (major to minor, mesh order)."""
    axes = [n for n, p in zip(ctx.axis_names, placements_) if p == Shard(dim)]
    block = 0
    for a in axes:
        block = block * ctx.axis_sizes[a] + ctx.mesh.get_local_rank(a)
    return block, axes


def shard_count(placements_: tuple, dim: int, ctx: ShardCtx) -> int:
    """How many blocks ``placements_`` split tensor dim ``dim`` into."""
    return math.prod(ctx.axis_sizes[n] for n, p in zip(ctx.axis_names, placements_)
                     if p == Shard(dim))


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) over a group in the forward, the identity in the
    backward: the sum is replicated on every rank of the group, so each
    rank's part gets the replicated gradient as it is (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (differentiable)."""
    return _SumOverRanks.apply(x, group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the ranks of ``group`` (no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


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
