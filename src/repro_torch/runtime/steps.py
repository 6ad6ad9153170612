"""Serving steps: prefill and decode callables.

The reference jit-compiles each step with its shardings; on one card the
port's steps are the plain serving functions with the config bound (no
compile, no sharding).  The train step waits for the training slice
(ROADMAP queue 1 item 10 (d)).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.models import serve as serve_mod
from repro_torch.models.config import ArchConfig


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
