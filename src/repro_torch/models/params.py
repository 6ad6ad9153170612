"""Parameter specification: declare each tensor once (shape, logical axes,
init), derive everything else from the spec: random weights from a
``torch.Generator``, shape-only stand-ins on the ``meta`` device.

A parameter tree is a nested ``dict`` whose leaves are ``ParamSpec``s (a
spec) or tensors (weights).  Leaves are visited in sorted key order, as
``jax.tree`` visits a dict.  The logical axes are kept as data: they name
how the reference shards each dimension and mean nothing on one card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

# a leaf larger than this is drawn in slices of at most this many elements
# (at least one row of its trailing dimensions), so the float32 draw stays
# small: deepseek-moe-16b's (27, 64, 2048, 1408) expert weights would need a
# 19.9 GB float32 temporary drawn whole, and a one-block jamba's
# (1, 4, 4, 8192, 24576) MoE weights 12.9 GB drawn a block at a time
SLICE_ELEMS = 1 << 24


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple            # logical axis per dim (the reference's sharding names)
    init: str = "normal"   # normal | zeros | ones | embed | small
    fan_in_dims: tuple[int, ...] = ()   # dims whose product is fan-in (normal)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure, their leaves passed alongside)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves by dotted key path ("layers.attn.wq"), in sorted key order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}.{k}" if prefix else k))
    return out


def spec_leaves(tree: Any) -> list[ParamSpec]:
    return list(flatten(tree).values())


def abstract(tree: Any, dtype: torch.dtype) -> Any:
    """ParamSpec tree -> tensors on the ``meta`` device (no allocation)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), tree)


def _scale(s: ParamSpec) -> float:
    if s.init == "embed":
        return 0.02
    fan_in = (np.prod([s.shape[d] for d in s.fan_in_dims])
              if s.fan_in_dims else s.shape[0])
    scale = 1.0 / math.sqrt(max(float(fan_in), 1.0))
    return scale * 0.1 if s.init == "small" else scale


def initialize(generator: torch.Generator, tree: Any, dtype: torch.dtype,
               device=None) -> Any:
    """ParamSpec tree -> random weights of ``dtype`` on ``device`` (default:
    the generator's device), drawn from ``generator`` leaf by leaf in sorted
    key order: ``normal`` N(0, 1) / sqrt(fan_in), ``small`` a tenth of that,
    ``embed`` N(0, 0.02^2), ``zeros``, ``ones``.  The same generator state
    on the same device gives the same weights."""
    gdev = generator.device
    device = torch.device(device) if device is not None else gdev

    def draw(shape, scale):
        x = torch.randn(shape, generator=generator, device=gdev, dtype=torch.float32)
        return x.mul_(scale).to(device=device, dtype=dtype)

    def init_one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        scale = _scale(s)
        if math.prod(s.shape) <= SLICE_ELEMS or len(s.shape) < 2:
            return draw(s.shape, scale)
        out = torch.empty(s.shape, dtype=dtype, device=device)
        # the fewest trailing dims of at most SLICE_ELEMS elements (the last
        # one at least) make a row; the leading dims flatten into rows
        lead = next(j for j in range(1, len(s.shape))
                    if math.prod(s.shape[j:]) <= SLICE_ELEMS or j == len(s.shape) - 1)
        flat = out.view(-1, *s.shape[lead:])
        rows = max(1, SLICE_ELEMS // math.prod(s.shape[lead:]))
        for i in range(0, flat.shape[0], rows):
            n = min(rows, flat.shape[0] - i)
            flat[i:i + n] = draw((n, *s.shape[lead:]), scale)
        return out

    return tree_map(init_one, tree)


def count_params(tree: Any) -> int:
    return sum(math.prod(s.shape) for s in spec_leaves(tree))


def stack_layers(n: int, spec: Any) -> Any:
    """Prepend a layer dim to every ParamSpec in ``spec``."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), (None, *s.axes), s.init,
                            tuple(d + 1 for d in s.fan_in_dims)), spec)


def check_tree(spec: Any, tree: Any, what: str = "params") -> None:
    """Refuse a weight tree whose key paths or shapes differ from ``spec``."""
    want = {k: tuple(s.shape) for k, s in flatten(spec).items()}
    got = flatten(tree)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what}: missing leaves {missing}, unexpected leaves {extra}")
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{what}: leaf {k} has shape {tuple(got[k].shape)}, "
                             f"the spec {shape}")
