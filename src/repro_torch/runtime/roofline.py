"""Roofline terms of a dry-run cell (port of ``repro.runtime.roofline``),
and the card's figures, the one source that ``chip_smoke.py``'s bounds
read too.

The card: NVIDIA H100 80GB HBM3 (SXM), at its 700 W power limit, from
NVIDIA's data sheet:

  PEAK_FLOPS   989 TFLOP/s   dense bf16 on the tensor cores
  HBM_BW       3.35 TB/s     HBM3
  PEAK_OPS     67 T/s        32-bit operations off the tensor cores (the
                             integer and bit work of the HDC kernels)
  LINK_BW      50 GB/s       a card's share of the network between nodes:
                             NDR InfiniBand, one 400 Gb/s port a card.
                             Every 16-wide axis of the production meshes
                             crosses an 8-card HGX node, so that is the
                             slowest link each of their collectives crosses.

The reference's figures are a TPU v5e's (197 TFLOP/s, 819 GB/s, 50 GB/s
a link) and stay the reference's.  A card set below 700 W runs slower
under load.

Three terms (seconds, per device; the counts of ``runtime/op_cost.py`` are
one rank's):

  compute    = flops / PEAK_FLOPS
  memory     = bytes / HBM_BW
  collective = sum_k w_k * bytes_k / LINK_BW, with the reference's weights:
               all-reduce 2.0 (a reduce-scatter and an all-gather), every
               other kind 1.0, over each kind's local output bytes.

The bound is the largest term.  ``model_flops_per_device`` /
``flops`` is the share of counted matrix work that the model needs
(recompute under remat shows up here), by the reference's formula.
"""

from __future__ import annotations

import math

CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
PEAK_OPS = 67e12
LINK_BW = 50e9

_COLL_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "ragged-all-to-all": 1.0}


def collective_seconds(colls: dict) -> float:
    return sum(_COLL_WEIGHT.get(k, 1.0) * v
               for k, v in colls.items() if k != "n_ops") / LINK_BW


def _n_devices(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    return math.prod(tuple(mesh.shape))


def roofline_terms(cost: dict, colls: dict, cfg, shape, mesh,
                   *, n_total: int, n_active: int) -> dict:
    """``cost``: {"flops", "bytes accessed"} per device; ``mesh``: a
    ``DeviceMesh``, a device count, or None (one device)."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    coll_s = collective_seconds(colls)
    n_dev = _n_devices(mesh)

    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else
                                   (shape.seq_len if shape.kind == "prefill" else 1))
    mult = 6.0 if shape.kind == "train" else 2.0
    n_embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    model_flops_global = mult * max(n_active - n_embed, 1) * tokens
    model_flops_per_dev = model_flops_global / n_dev

    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s,
            "bottleneck": max((("compute", compute_s), ("memory", memory_s),
                               ("collective", coll_s)), key=lambda kv: kv[1])[0],
            "model_flops_per_device": model_flops_per_dev,
            "useful_flops_fraction": (model_flops_per_dev / flops if flops else 0.0),
            "step_time_bound_s": max(compute_s, memory_s, coll_s)}


def memory_analysis_dict(mem: dict) -> dict:
    """The reference's memory keys (``runtime/op_cost.py``'s counts of them)
    and ``peak_bytes_per_device_est`` = arguments + outputs + temporaries
    - outputs aliasing an argument."""
    out = {k: int(mem[k]) for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                     "temp_size_in_bytes", "alias_size_in_bytes")}
    out["peak_bytes_per_device_est"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out
