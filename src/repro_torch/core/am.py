"""Associative memory search (port of ``repro.core.am``): a batched packed
popcount "matmul" (..., W) x (C, W) -> (..., C)."""

from __future__ import annotations

import torch

from repro_torch.core import hv


def am_scores_sparse(query: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """popcount(q AND c) -> (..., C) int32."""
    return hv.popcount(query.unsqueeze(-2) & classes, axis=-1)


def am_scores_dense(query: torch.Tensor, classes: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """D - popcount(q XOR c) -> (..., C) int32."""
    return dim - hv.popcount(query.unsqueeze(-2) ^ classes, axis=-1)


def am_predict(scores: torch.Tensor) -> torch.Tensor:
    """argmax over classes; ties resolve to the lower class index."""
    return torch.argmax(scores, dim=-1).to(torch.int32)
