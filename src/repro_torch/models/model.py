"""Model assembly for the LM zoo's serving families.

Families served by the port:

dense   pre-norm GQA transformer (qwen3*, llama3.2-3b, command-r-35b)
moe     dense attention + MoE FFN (deepseek-moe-16b, moonshot-v1-16b-a3b);
        ``first_k_dense`` leading layers keep a dense FFN
vlm     dense decoder consuming [media embeddings ; text embeddings]
        (internvl2-2b; the ViT frontend is a stub fed with embeddings)

Layer parameters are stacked over layers, as the reference's spec has
them, and the serving functions (``models/serve.py``) walk the stack a
layer at a time.  ``LanguageModel`` owns the weights as ``nn.Parameter``s
under the spec's key paths ("layers.attn.wq"), in the reference's layouts,
so a reference parameter tree carries across without transposes
(``convert.lm_params_from_reference``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import embed, embed_spec, mlp_spec, rmsnorm_spec
from repro_torch.models.params import (ParamSpec, check_tree, initialize,
                                       stack_layers)

SERVED_FAMILIES = ("dense", "vlm", "moe")
# where each family the port does not serve yet stands in ROADMAP queue 1
_NOT_YET = {"ssm": "item 10 (b), SSM and hybrid serving",
            "hybrid": "item 10 (b), SSM and hybrid serving",
            "encdec": "item 10 (c), encoder-decoder and audio",
            "audio": "item 10 (c), encoder-decoder and audio"}


def check_family(cfg: ArchConfig) -> None:
    if cfg.family in SERVED_FAMILIES:
        return
    if cfg.family in _NOT_YET:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP queue 1 {_NOT_YET[cfg.family]})")
    raise ValueError(cfg.family)


# ===========================================================================
# parameter specs
# ===========================================================================

def _dense_layer_spec(cfg: ArchConfig) -> dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn.attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model), "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}


def _moe_layer_spec(cfg: ArchConfig) -> dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn.attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model), "moe": moe_mod.moe_spec(cfg)}


def model_spec(cfg: ArchConfig) -> dict:
    check_family(cfg)
    spec: dict[str, Any] = {
        "embed": embed_spec(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((cfg.d_model, cfg.vocab), ("fsdp", "tp"))
    if cfg.family in ("dense", "vlm"):
        spec["layers"] = stack_layers(cfg.n_layers, _dense_layer_spec(cfg))
    else:
        if cfg.first_k_dense:
            spec["dense_layers"] = stack_layers(cfg.first_k_dense,
                                                _dense_layer_spec(cfg))
        spec["layers"] = stack_layers(cfg.n_layers - cfg.first_k_dense,
                                      _moe_layer_spec(cfg))
    return spec


# ===========================================================================
# inputs
# ===========================================================================

def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Tokens (+ optional stubbed media embeddings) -> (B, L, d)."""
    x = embed(params["embed"], batch["tokens"])
    if cfg.family == "vlm" and "media" in batch:
        x = torch.cat([batch["media"].to(x.dtype), x], dim=1)
    return x


# ===========================================================================
# the module
# ===========================================================================

def _register(module: nn.Module, tree: dict) -> None:
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            child = nn.Module()
            _register(child, v)
            module.add_module(k, child)
        else:
            module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _tree(module: nn.Module) -> dict:
    out: dict[str, Any] = dict(module._parameters)
    out.update({k: _tree(m) for k, m in module._modules.items()})
    return out


class LanguageModel(nn.Module):
    """An LM of the zoo for serving: the weights of ``model_spec(cfg)`` as
    parameters under the spec's key paths, and ``prefill``/``decode_step``
    over them (``models/serve.py``)."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        check_tree(model_spec(cfg), params)
        self.cfg = cfg
        _register(self, params)

    @classmethod
    def init(cls, generator: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype | None = None, device=None) -> "LanguageModel":
        """Random weights drawn from ``generator`` (``params.initialize``),
        of ``dtype`` (default: ``cfg.dtype``) on ``device`` (default: the
        card; raises without one unless ``device="cpu"``)."""
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        return cls(cfg, initialize(generator, model_spec(cfg), dtype, dev))

    def params(self) -> dict:
        """The weights as the nested dict the serving functions take."""
        return _tree(self)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def prefill(self, batch: dict, cache_seq: int):
        from repro_torch.models import serve

        return serve.prefill(self.params(), batch, self.cfg, cache_seq)

    def decode_step(self, tokens: torch.Tensor, caches: dict, pos: int):
        from repro_torch.models import serve

        return serve.decode_step(self.params(), tokens, caches, pos, self.cfg)
