"""Fleet temporal bundling entry points (port of
``repro.kernels.hdc_fleet.ops``).

* ``fleet_counts`` — plain bit-plane prefix path on per-cycle spatial HVs;
* ``fleet_counts_fused`` — raw uint8 codes + the stacked pre-bound bank in,
  per-slot counts out, through ``fleet_counts_kernel`` (the CUDA kernel
  for CUDA tensors, its plain version for CPU tensors).
"""

from __future__ import annotations

import torch

from repro_torch.core.classifier import HDCConfig
from repro_torch.kernels import build
from repro_torch.kernels.common import plain, require, use_plain
from repro_torch.kernels.hdc_fleet.ref import (emission_masks,
                                               fleet_counts_plain,
                                               fleet_counts_ref)

MODES = {"or": 0, "thin": 1, "majority": 2}


def spatial_mode(cfg: HDCConfig) -> tuple[str, int]:
    """(mode, threshold) of the kernel's spatial-bundle stage for ``cfg``."""
    if cfg.variant == "dense":
        return "majority", 0
    if cfg.variant == "sparse_naive" or cfg.spatial_thinning:
        return "thin", cfg.spatial_threshold
    return "or", 0


def fleet_counts(words: torch.Tensor, filled: torch.Tensor,
                 lengths: torch.Tensor, cfg: HDCConfig) -> torch.Tensor:
    """(S, T, W) spatial HVs -> (S, K+1, D) int32 frame-slot counts."""
    return fleet_counts_ref(words, filled, lengths, window=cfg.window,
                            dim=cfg.dim)


def fleet_counts_kernel(tables: torch.Tensor, owner: torch.Tensor,
                        codes: torch.Tensor, tm: torch.Tensor, *, mode: str,
                        dim: int, threshold: int = 1,
                        chan_mask: torch.Tensor | None = None) -> torch.Tensor:
    """tables (P, C, K, W) int32, owner (S,) int32, codes (S, T32, C) uint8
    (T32 % 32 == 0), tm (S, K1, T32 // 32) int32, optional chan_mask (S, C)
    (1 = live) -> (S, K1, D) int32 slot counts."""
    if mode not in MODES:
        raise ValueError(f"unknown spatial mode {mode!r}")
    ops = [tables, owner, codes, tm] + ([] if chan_mask is None else [chan_mask])
    if use_plain(*ops):
        return plain("hdc_fleet", fleet_counts_plain, tables, owner, codes, tm,
                     mode=mode, dim=dim, threshold=threshold, chan_mask=chan_mask)
    p, c, k, w = tables.shape
    s, t32, _ = codes.shape
    if t32 % 32 or w * 32 != dim:
        raise ValueError(f"need T32 % 32 == 0 and W * 32 == dim; got "
                         f"T32={t32}, W={w}, dim={dim}")
    k1 = tm.shape[1]
    require(tables, "tables", torch.int32)
    require(owner, "owner", torch.int32, (s,))
    require(codes, "codes", torch.uint8, (s, t32, c))
    require(tm, "tm", torch.int32, (s, k1, t32 // 32))
    cm_ptr = None
    if chan_mask is not None:
        chan_mask = chan_mask.to(torch.int32).contiguous()
        require(chan_mask, "chan_mask", torch.int32, (s, c))
        cm_ptr = chan_mask.data_ptr()
    out = torch.empty((s, k1, dim), dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    # the sessions in owner order, so that a block's sessions share a bank
    order = torch.argsort(torch.clamp(owner, 0, p - 1), stable=True).to(torch.int32)
    err = build.lib().hdc_fleet_launch(
        tables.data_ptr(), owner.data_ptr(), order.data_ptr(), codes.data_ptr(),
        tm.data_ptr(), cm_ptr, out.data_ptr(), s, t32, c, k, w, k1, p, MODES[mode],
        int(threshold),  # repro-lint: disable=RPR002  -- a Python int, not a tensor
        build.stream_ptr(codes))
    build.check(err, "hdc_fleet")
    fleet_counts_kernel.launches += 1
    return out


fleet_counts_kernel.launches = 0


def fleet_counts_fused(tables: torch.Tensor, owner: torch.Tensor,
                       codes: torch.Tensor, filled: torch.Tensor,
                       lengths: torch.Tensor, cfg: HDCConfig,
                       tables_xor: torch.Tensor | None = None,
                       chan_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(S, T, C) raw uint8 codes -> (S, K+1, D) int32 slot counts in one
    fused pass: pads the cycle axis to a 32 multiple (padded cycles gather
    row 0 and are masked off) and builds the emission masks from
    ``(filled, lengths)``.  ``tables_xor`` (the bank's shape), the fault
    injection hook of ``reliability/faults.py``, is XORed into the bank
    here, next to the launch, so the kernel reads the faulted bank through
    its usual operand."""
    s, t, c = codes.shape
    if tables_xor is not None:
        tables = tables ^ tables_xor
    t32 = -(-t // 32) * 32
    if t32 != t:
        codes = torch.cat([codes, codes.new_zeros((s, t32 - t, c))], 1)
    tm = emission_masks(filled, lengths, t_pad=t, window=cfg.window)
    mode, threshold = spatial_mode(cfg)
    return fleet_counts_kernel(tables, owner, codes.contiguous(), tm,
                               mode=mode, dim=cfg.dim, threshold=threshold,
                               chan_mask=chan_mask)
