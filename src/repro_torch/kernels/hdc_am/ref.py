"""Plain PyTorch version of the AM similarity-search kernel."""

from __future__ import annotations

import torch

from repro_torch.core import am


def am_search_ref(queries: torch.Tensor, classes: torch.Tensor, *, mode: str,
                  dim: int) -> torch.Tensor:
    if mode == "overlap":
        return am.am_scores_sparse(queries, classes)
    if mode == "hamming":
        return am.am_scores_dense(queries, classes, dim)
    raise ValueError(mode)
