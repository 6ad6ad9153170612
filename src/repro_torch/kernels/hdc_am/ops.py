"""AM similarity search: CUDA kernel for CUDA tensors, plain version for
CPU tensors (port of ``repro.kernels.hdc_am.ops``)."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import plain, require, use_plain
from repro_torch.kernels.hdc_am.ref import am_search_ref

MODES = {"overlap": 0, "hamming": 1}


def am_search(queries: torch.Tensor, classes: torch.Tensor, *,
              mode: str = "overlap", dim: int = 1024) -> torch.Tensor:
    """(..., W) int32 queries x (C, W) int32 classes -> (..., C) int32
    scores; leading query dims are flattened and restored."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {tuple(MODES)}")
    lead = queries.shape[:-1]
    w = queries.shape[-1]
    q2 = queries.reshape(-1, w)
    if use_plain(q2, classes):
        out = plain("hdc_am", am_search_ref, q2, classes, mode=mode, dim=dim)
    else:
        q2 = q2.contiguous()
        c = classes.shape[0]
        require(q2, "queries", torch.int32)
        require(classes, "classes", torch.int32, (c, w))
        out = torch.empty((q2.shape[0], c), dtype=torch.int32,
                          device=q2.device)
        if out.numel() == 0:
            return out.reshape(*lead, c)
        err = build.lib().hdc_am_launch(
            q2.data_ptr(), classes.data_ptr(), out.data_ptr(), q2.shape[0],
            c, w, MODES[mode], dim, build.stream_ptr(q2))
        build.check(err, "hdc_am")
        am_search.launches += 1
    return out.reshape(*lead, classes.shape[0])


am_search.launches = 0
