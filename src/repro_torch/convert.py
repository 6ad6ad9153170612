"""Carry a trained pipeline, or an LM's weights, from numpy arrays into
the port.

The reference draws its codebooks and weights with ``jax.random``, which
``torch.Generator`` cannot replay, so parity between the two packages
transfers them: the caller turns the reference's leaves into numpy arrays
(``np.asarray``) and its config into a field mapping, and this module
rebuilds the port's objects from those.  Nothing here imports the
reference package.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Mapping

import numpy as np
import torch

from repro_torch.core import hv
from repro_torch.core.classifier import HDCConfig
from repro_torch.core.im import DenseIMParams, IMParams
from repro_torch.core.online import OnlineAMState
from repro_torch.core.pipeline import HDCPipeline, _check_cfg
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LanguageModel, model_spec
from repro_torch.models.params import check_tree, tree_map

_CFG_FIELDS = {f.name for f in fields(HDCConfig)}


def config_from_fields(cfg_fields: Mapping) -> HDCConfig:
    """The port's ``HDCConfig`` from a mapping of the reference's config
    fields; ``backend`` (the tensor device selects the path here) is
    dropped, and any other unknown field raises."""
    extra = set(cfg_fields) - _CFG_FIELDS - {"backend"}
    if extra:
        raise ValueError(f"unknown config fields {sorted(extra)}")
    return HDCConfig(**{k: v for k, v in cfg_fields.items() if k in _CFG_FIELDS})


def _params(cfg: HDCConfig, item: np.ndarray, elec: np.ndarray, dev):
    """The codebooks of ``cfg.variant``: packed uint32 words for dense,
    uint8 segment positions for the sparse variants (the naive one with its
    packed caches, as the reference's init builds it)."""
    if cfg.variant == "dense":
        want = ((cfg.channels, cfg.codes, cfg.words), (cfg.channels, cfg.words))
        dtype = np.uint32
    else:
        want = ((cfg.channels, cfg.codes, cfg.segments),
                (cfg.channels, cfg.segments))
        dtype = np.uint8
    item = np.asarray(item, dtype)
    elec = np.asarray(elec, dtype)
    if (item.shape, elec.shape) != want:
        raise ValueError(f"codebooks {item.shape}, {elec.shape} do not match "
                         f"the config {want}")
    if cfg.variant == "dense":
        return DenseIMParams(item_packed=torch.from_numpy(hv.to_i32(item).copy()).to(dev),
                             elec_packed=torch.from_numpy(hv.to_i32(elec).copy()).to(dev),
                             dim=cfg.dim)
    params = IMParams(item_pos=torch.from_numpy(item.copy()).to(dev),
                      elec_pos=torch.from_numpy(elec.copy()).to(dev),
                      dim=cfg.dim, segments=cfg.segments)
    return params.with_packed(cfg.variant == "sparse_naive")


def pipeline_from_arrays(cfg_fields: Mapping, item: np.ndarray,
                         elec: np.ndarray, *,
                         class_hvs: np.ndarray | None = None,
                         am_counts: np.ndarray | None = None,
                         am_n: np.ndarray | None = None,
                         device=None) -> HDCPipeline:
    """Rebuild a pipeline from its codebooks (``item``, ``elec``: the
    reference's ``item_packed``/``elec_packed`` uint32 words for dense,
    ``item_pos``/``elec_pos`` uint8 positions for the sparse variants),
    class HVs (uint32 words, carried as int32 with the same bits) and the
    counter-file state, placed on ``device`` (default: the card)."""
    cfg = config_from_fields(cfg_fields)
    _check_cfg(cfg)
    dev = resolve_device(device)
    params = _params(cfg, item, elec, dev)
    chvs = None
    if class_hvs is not None:
        words = np.asarray(class_hvs)
        if words.shape != (cfg.n_classes, cfg.words):
            raise ValueError(f"class_hvs {words.shape} != "
                             f"{(cfg.n_classes, cfg.words)}")
        chvs = torch.from_numpy(hv.to_i32(words).copy()).to(dev)
    state = None
    if (am_counts is None) != (am_n is None):
        raise ValueError("am_counts and am_n come together")
    if am_counts is not None:
        state = OnlineAMState(
            counts=torch.from_numpy(np.asarray(am_counts, np.int32).copy()).to(dev),
            n=torch.from_numpy(np.asarray(am_n, np.int32).copy()).to(dev))
    return HDCPipeline(params=params, cfg=cfg, class_hvs=chvs, am_state=state)


def _leaf_tensor(a) -> torch.Tensor:
    """A numpy leaf as a tensor of the same values; bfloat16 (numpy's
    ``ml_dtypes`` extension type) goes through float32, which holds it
    exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def lm_params_from_reference(cfg: ArchConfig, tree: Mapping,
                             device=None) -> LanguageModel:
    """The port's ``LanguageModel`` holding exactly the values of a
    reference parameter tree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them), on ``device``
    (default: the card).  The layouts are the reference's, so no leaf is
    transposed; a missing, extra or mis-shaped leaf is refused."""
    check_tree(model_spec(cfg), tree, what="reference params")
    dev = resolve_device(device)
    return LanguageModel(cfg, tree_map(lambda a: _leaf_tensor(a).to(dev), tree))
