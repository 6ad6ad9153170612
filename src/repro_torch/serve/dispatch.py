"""Multi-patient dispatch machinery for the fleet (port of
``repro.serve.dispatch``: bank validation, pre-bound codebooks, the OR-tree
code-domain spatial encode and owner-gathered AM scoring).

Binding is a pure function of (channel, LBP code), so the serving path
precomputes the BOUND packed HV per (channel, code) once per patient; per
cycle the spatial encode is a table gather + OR tree.  The per-patient
tables stack along a leading axis and each stream gathers its rows through
an ``owner`` index, so one launch serves any mix of patients.
"""

from __future__ import annotations

import dataclasses
from dataclasses import replace
from typing import Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import binding, hv
from repro_torch.core.pipeline import HDCConfig, HDCPipeline


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
    """Pre-bound codebook for one patient: (channels, codes, W) int32."""
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


def owner_spatial_codes(tables: torch.Tensor, owner: torch.Tensor,
                        codes: torch.Tensor, cfg: HDCConfig) -> torch.Tensor:
    """Code-domain gather + OR-tree bundle: (S, T, channels) uint8 codes ->
    (S, T, W) per-cycle packed spatial HVs (the OR branch of the
    reference: ``sparse_compim`` without spatial thinning)."""
    if cfg.variant != "sparse_compim" or cfg.spatial_thinning:
        raise ValueError("only the OR-tree datapath (sparse_compim without "
                         "spatial thinning) is ported")
    s, t, c = codes.shape
    p, _, k, w = tables.shape
    if t == 0:
        return torch.zeros((s, 0, w), dtype=torch.int32, device=codes.device)
    # clamp BEFORE flattening the (patient, channel, code) index: an
    # out-of-alphabet code must clip within its channel's rows
    flat = tables.reshape(p * c * k, w)
    ci = torch.clamp(codes.to(torch.int64), max=k - 1)
    ob = owner.to(torch.int64)[:, None] * (c * k)                 # (S, 1)
    lvl = [flat[ob + ch * k + ci[:, :, ch]] for ch in range(c)]    # C x (S, T, W)
    while len(lvl) > 1:
        nxt = [a | b for a, b in zip(lvl[0::2], lvl[1::2])]
        if len(lvl) % 2:
            nxt.append(lvl[-1])
        lvl = nxt
    return lvl[0]


def owner_am_scores(frames: torch.Tensor, class_rows: torch.Tensor,
                    cfg: HDCConfig) -> torch.Tensor:
    """(..., W) frames vs (..., C, W) owner-gathered class HVs -> (..., C)
    overlap scores."""
    q = frames.unsqueeze(-2)
    if cfg.variant == "dense":
        return cfg.dim - hv.hamming(q, class_rows)
    return hv.overlap(q, class_rows)
