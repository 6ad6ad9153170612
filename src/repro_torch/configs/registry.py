"""Architecture registry: ``--arch <id>`` -> ArchConfig.

Also owns the per-arch shape applicability matrix (which of the four
input shapes each architecture runs).  Every config loads and serves.
"""

from __future__ import annotations

import importlib

from repro_torch.data.lm import SHAPES, ShapeSpec
from repro_torch.models.config import ArchConfig

ARCH_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen3-0.6b": "qwen3_0_6b",
    "command-r-35b": "command_r_35b",
    "llama3.2-3b": "llama3_2_3b",
    "qwen3-1.7b": "qwen3_1_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "internvl2-2b": "internvl2_2b",
}

ARCH_IDS = tuple(ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped): long_500k only for sub-quadratic archs;
    every arch has a decoder, so every other shape runs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention at 524,288 ctx — skipped per assignment"
    return True, ""


def all_cells():
    """Every (arch x shape) cell with its applicability."""
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in SHAPES.values():
            ok, reason = shape_applicable(cfg, shape)
            yield arch_id, cfg, shape, ok, reason
