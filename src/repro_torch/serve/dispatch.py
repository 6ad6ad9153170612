"""Multi-patient dispatch machinery for the fleet (port of
``repro.serve.dispatch``: bank validation, pre-bound codebooks, the
code-domain spatial encode for every variant, batched frame encoding,
owner-gathered AM scoring and its ECC-protected read).

Binding is a pure function of (channel, LBP code), so the serving path
precomputes the BOUND packed HV per (channel, code) once per patient; per
cycle the spatial encode is a table gather + OR tree (or, for spatial
thinning, the naive variant and dense, an adder tree + threshold or
majority).  The per-patient tables stack along a leading axis and each
stream gathers its rows through an ``owner`` index, so one launch serves
any mix of patients.  A channel mask (per stream, 1 = live) drops
quarantined electrodes from the bundle inside the fleet kernel;
``effective_spatial_threshold`` and ``reduced_channel_config`` state what
that equals: the pipeline with the dead electrodes physically absent.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import binding, bundling, hv
from repro_torch.core.pipeline import HDCConfig, HDCPipeline
from repro_torch.reliability import ecc


def datapath_key(cfg: HDCConfig) -> HDCConfig:
    """Normalise a per-patient config to its shared-datapath key: the
    temporal threshold is a per-patient register and ``class_density`` only
    affects training; everything else must agree across a bank."""
    return replace(cfg, temporal_threshold=0, class_density=0.5)


def validate_bank(pipelines: Mapping[Hashable, HDCPipeline]) -> HDCConfig:
    """Check a patient -> trained-pipeline bank shares one datapath and one
    device; returns the normalised datapath config."""
    if not pipelines:
        raise ValueError("need at least one pipeline")
    first = next(iter(pipelines.values()))
    key = datapath_key(first.cfg)
    for pid, p in pipelines.items():
        if p.class_hvs is None:
            raise ValueError(
                f"patient {pid!r}: pipeline is untrained "
                "(call train_one_shot before serving)")
        other = datapath_key(p.cfg)
        if other != key:
            bad = [f.name for f in dataclasses.fields(HDCConfig)
                   if getattr(other, f.name) != getattr(key, f.name)]
            raise ValueError(
                f"patient {pid!r}: {'/'.join(bad)} mismatch in bank "
                "(per-patient configs may differ only in temporal_threshold "
                "and class_density)")
        if p.device != first.device:
            raise ValueError(f"patient {pid!r}: pipeline lies on {p.device}, "
                             f"the bank on {first.device}")
    return key


def bound_table(params, cfg: HDCConfig) -> torch.Tensor:
    """Pre-bound codebook for one patient: (channels, codes, W) int32.
    Sparse variants bind through the position-domain identity, dense by
    XOR."""
    if cfg.variant == "dense":
        return binding.bind_xor(params.item_packed, params.elec_packed[:, None])
    pos = binding.bind_positions(params.item_pos, params.elec_pos[:, None],
                                 cfg.seg_len)
    return hv.positions_to_packed(pos, cfg.dim, cfg.segments)


def stack_bound_tables(pipes: Sequence[HDCPipeline]
                       ) -> tuple[torch.Tensor, np.ndarray]:
    """Stack the unique per-patient pre-bound codebooks into one bank:
    (P_unique, channels, codes, W) and each pipeline's row index."""
    row_of: dict[int, int] = {}
    unique: list[torch.Tensor] = []
    rows: list[int] = []
    for p in pipes:
        k = id(p.params)
        if k not in row_of:
            row_of[k] = len(unique)
            unique.append(bound_table(p.params, datapath_key(p.cfg)))
        rows.append(row_of[k])
    return torch.stack(unique), np.asarray(rows, np.int32)


def effective_spatial_threshold(live: torch.Tensor, cfg: HDCConfig
                                ) -> torch.Tensor:
    """Thinning threshold renormalised to the live channel count:
    ``ceil(spatial_threshold * live / channels)``, floored at 1; with every
    channel live this is ``cfg.spatial_threshold``."""
    live = live.to(torch.int32)
    c = cfg.channels
    return torch.clamp(torch.div(cfg.spatial_threshold * live + c - 1, c,
                                 rounding_mode="floor"), min=1)


def reduced_channel_config(cfg: HDCConfig, live: int) -> HDCConfig:
    """The config of the reduced-channel oracle for a mask with ``live``
    channels alive: the pipeline an implant with the dead electrodes
    physically absent would run.  Masked encodes are bit-exact with it."""
    thr = max(1, -(-cfg.spatial_threshold * live // cfg.channels))
    return replace(cfg, channels=live, spatial_threshold=thr)


def owner_spatial_encode(tables: torch.Tensor, owner: torch.Tensor,
                         codes: torch.Tensor, cfg: HDCConfig) -> torch.Tensor:
    """Owner-gathered spatial encode: (B, ..., channels) -> (B, ..., W).

    The reference formulation: it materialises the full (B, ..., C, W)
    bound expansion; ``owner_spatial_codes`` is held bit-exact with it."""
    c, k = tables.shape[1:3]
    ch = torch.arange(c, device=codes.device)
    o = owner.to(torch.int64).reshape((-1,) + (1,) * (codes.ndim - 1))
    ci = torch.clamp(codes.to(torch.int64), max=k - 1)
    bound = tables[o, ch, ci]                                  # (B, ..., C, W)
    if cfg.variant == "dense":
        counts = hv.unpacked_counts(bound, axis=-2, dim=cfg.dim)
        return hv.majority_pack(counts, cfg.channels, cfg.dim)
    if cfg.variant == "sparse_naive" or cfg.spatial_thinning:
        return bundling.spatial_bundle_thinned(bound, cfg.dim,
                                               cfg.spatial_threshold)
    return hv.or_reduce(bound, axis=-2)


def spatial_block_len(t_pad: int, cfg: HDCConfig) -> int:
    """Largest divisor of t_pad <= min(8, window): the time block of the
    adder-tree code-domain spatial encode, which bounds its gather
    temporary to (channels, S, block, W) words."""
    cap = min(8, cfg.window, t_pad)
    return max(b for b in range(1, cap + 1) if t_pad % b == 0)


def owner_spatial_codes(tables: torch.Tensor, owner: torch.Tensor,
                        codes: torch.Tensor, cfg: HDCConfig,
                        chan_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Code-domain gather + bundle: (S, T, channels) uint8 codes -> (S, T, W)
    per-cycle packed spatial HVs, without the (S, T, C, W) bound expansion.

    * OR tree (``sparse_compim`` without thinning): one gather per channel
      over the whole chunk, pairwise-ORed as a tree.
    * adder tree (thinning, ``sparse_naive``, dense majority): one gather
      per ``spatial_block_len`` time block, the channel stack zero-padded to
      a 32-multiple so the counts take the bit-plane adder, then threshold
      or majority pack.

    Out-of-alphabet codes clamp within their channel's rows.  ``chan_mask``
    (S, channels), 1 = live, drops the quarantined channels from the bundle
    (the adder tree's threshold renormalised to the live count, dense's
    majority taken over it), bit-exact with the same encode on the
    physically reduced channel set (the fleet's stage probe; its step masks
    inside the fleet kernel)."""
    s, t, c = codes.shape
    p, _, k, w = tables.shape
    if t == 0:
        return torch.zeros((s, 0, w), dtype=torch.int32, device=codes.device)
    # clamp BEFORE flattening the (patient, channel, code) index: an
    # out-of-alphabet code must clip within its channel's rows
    flat = tables.reshape(p * c * k, w)
    ci = torch.clamp(codes.to(torch.int64), max=k - 1)
    if cfg.variant == "sparse_compim" and not cfg.spatial_thinning:
        ob = owner.to(torch.int64)[:, None] * (c * k)             # (S, 1)
        lvl = [flat[ob + ch * k + ci[:, :, ch]] for ch in range(c)]  # C x (S, T, W)
        if chan_mask is not None:  # OR identity: masked terms vanish
            m = chan_mask.to(torch.int32)
            lvl = [r * m[:, ch, None, None] for ch, r in enumerate(lvl)]
        while len(lvl) > 1:
            nxt = [a | b for a, b in zip(lvl[0::2], lvl[1::2])]
            if len(lvl) % 2:
                nxt.append(lvl[-1])
            lvl = nxt
        return lvl[0]

    block = spatial_block_len(t, cfg)
    ob = owner.to(torch.int64)[None, :, None] * (c * k)           # (1, S, 1)
    cbase = (torch.arange(c, device=codes.device) * k)[:, None, None]  # (C, 1, 1)
    c32 = -(-c // 32) * 32
    n_maj, thr = cfg.channels, cfg.spatial_threshold
    if chan_mask is not None:
        cm = chan_mask.to(torch.int32).T[:, :, None, None]       # (C, S, 1, 1)
        live = chan_mask.to(torch.int32).sum(dim=1, dtype=torch.int32)[:, None, None]
        n_maj, thr = live, effective_spatial_threshold(live, cfg)
    out = []
    for t0 in range(0, t, block):
        idx = ob + cbase + ci[:, t0:t0 + block].permute(2, 0, 1)  # (C, S, block)
        bound = flat[idx]                                       # (C, S, block, W)
        if chan_mask is not None:  # zeroed rows count nothing below
            bound = bound * cm
        if c32 != c:  # zero rows count nothing; keeps the bit-plane route
            bound = torch.cat([bound, bound.new_zeros((c32 - c, *bound.shape[1:]))])
        counts = hv.unpacked_counts(bound, axis=0, dim=cfg.dim)
        if cfg.variant == "dense":
            out.append(hv.majority_pack(counts, n_maj, cfg.dim))
        else:
            out.append(hv.threshold_pack(counts, thr))
    return torch.cat(out, dim=1)


def owner_encode_frames(tables: torch.Tensor, owner: torch.Tensor,
                        thresholds: torch.Tensor, codes: torch.Tensor,
                        cfg: HDCConfig) -> torch.Tensor:
    """Batched multi-patient ``encode_frames``: (B, T, channels) ->
    (B, F, W), with ``thresholds`` (B,) each stream's temporal threshold
    (dense: the window majority instead)."""
    b, t, _ = codes.shape
    f = t // cfg.window
    words = owner_spatial_codes(tables, owner, codes[:, : f * cfg.window], cfg)
    spatial = words.reshape(b, f, cfg.window, cfg.words)
    counts = bundling.temporal_counts(spatial, cfg.dim)        # (B, F, D)
    if cfg.variant == "dense":
        return hv.majority_pack(counts, cfg.window, cfg.dim)
    return hv.threshold_pack(counts, thresholds.reshape(-1, 1, 1))


def owner_am_scores(frames: torch.Tensor, class_rows: torch.Tensor,
                    cfg: HDCConfig) -> torch.Tensor:
    """(..., W) frames vs (..., C, W) owner-gathered class HVs -> (..., C)
    overlap scores."""
    q = frames.unsqueeze(-2)
    if cfg.variant == "dense":
        return cfg.dim - hv.hamming(q, class_rows)
    return hv.overlap(q, class_rows)


def owner_am_scores_protected(frames: torch.Tensor, rows: torch.Tensor,
                              check: torch.Tensor, cfg: HDCConfig, scheme: str
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """AM scoring through the ECC word codec (``reliability/ecc.py``):
    ``rows`` (S, C, W) are the possibly corrupted class rows as read and
    ``check`` their possibly corrupted check words; every word is decoded
    once a step and the corrected rows score the (S, K, W) frames.  Returns
    ``(scores (S, K, C), counters (S, 3) int32)``, the counters this read's
    per-session word counts of [corrected, detected, uncorrectable]
    (detected = corrected + uncorrectable for SECDED; parity only
    detects)."""
    corrected, status = ecc.decode(rows, check, scheme)
    scores = owner_am_scores(frames, corrected[:, None], cfg)
    red = tuple(range(1, status.ndim))
    counters = torch.stack([
        (status == ecc.CORRECTED).sum(red, dtype=torch.int32),
        (status != ecc.CLEAN).sum(red, dtype=torch.int32),
        (status == ecc.UNCORRECTABLE).sum(red, dtype=torch.int32),
    ], dim=-1)
    return scores, counters
