"""Error-feedback int8 gradient compression: the port of the reference's
``optim/compress.py``.

Each gradient, plus the residual carried from the step before, is
quantised per tensor to int8 with scale ``max|g| / 127`` (rounded half to
even, as ``jnp.round`` rounds) and dequantised; what the quantisation lost
is the new residual, added back next step (Karimireddy et al., 2019).  On
one card there is no reduction to feed: the round trip changes the
gradients the optimizer sees exactly as the reference's does before its
cross-pod all-reduce.

Usage inside a train step (``grad_compress``)::

    grads, residual = compress_decompress(grads, residual)
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import tree_map


def _q(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: Any, residual: Any) -> tuple[Any, Any]:
    """-> (the dequantised gradients, each in its gradient's dtype; the new
    residual, in the residual's dtype)."""
    def one(g, r):
        g32 = g.float() + r.float()
        q, scale = _q(g32)
        d = q.float() * scale
        return d.to(g.dtype), (g32 - d).to(r.dtype)

    out = tree_map(one, grads, residual)
    deq = tree_map(lambda t: t[0], out)
    res = tree_map(lambda t: t[1], out)
    return deq, res


def init_residual(params: Any) -> Any:
    """A zero bf16 residual shaped and placed as ``params``, on their
    devices."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.bfloat16,
                                               memory_format=torch.contiguous_format),
                    params)
