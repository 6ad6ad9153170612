"""Model assembly for the LM zoo's serving families.

Families:

dense   pre-norm GQA transformer (qwen3*, llama3.2-3b, command-r-35b)
moe     dense attention + MoE FFN (deepseek-moe-16b, moonshot-v1-16b-a3b);
        ``first_k_dense`` leading layers keep a dense FFN
ssm     attention-free Mamba-1 stack (falcon-mamba-7b)
hybrid  Jamba period blocks: per ``attn_period`` layers 1 attention + the
        rest Mamba; the FFN alternates MLP / MoE (even / odd sublayers)
encdec  bidirectional encoder + causal decoder with cross attention
audio   (seamless-m4t-medium; the audio frontend is a stub fed with frames)
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
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (embed, embed_spec, mlp, mlp_spec, rmsnorm,
                                       rmsnorm_spec)
from repro_torch.models.params import (ParamSpec, check_tree, initialize,
                                       stack_layers, tree_map)

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec", "audio")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ===========================================================================
# parameter specs
# ===========================================================================

def _dense_layer_spec(cfg: ArchConfig) -> dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn.attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model), "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}


def _moe_layer_spec(cfg: ArchConfig) -> dict:
    return {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn.attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model), "moe": moe_mod.moe_spec(cfg)}


def _mamba_layer_spec(cfg: ArchConfig) -> dict:
    return {"ln": rmsnorm_spec(cfg.d_model), "mamba": mb.mamba_spec(cfg)}


def _hybrid_block_spec(cfg: ArchConfig) -> dict:
    """One Jamba period block: sublayer 0 = attention, 1..p-1 = mamba;
    the FFN alternates MLP (even sublayers) / MoE (odd sublayers)."""
    p = cfg.attn_period
    return {
        "attn": {"ln": rmsnorm_spec(cfg.d_model), "attn": attn.attention_spec(cfg)},
        "mamba": stack_layers(p - 1, _mamba_layer_spec(cfg)),
        "mlp": stack_layers(p // 2, {"ln": rmsnorm_spec(cfg.d_model),
                                     "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}),
        "moe": stack_layers(p // 2, {"ln": rmsnorm_spec(cfg.d_model),
                                     "moe": moe_mod.moe_spec(cfg)}),
    }


def _encdec_layer_specs(cfg: ArchConfig) -> tuple[dict, dict]:
    enc = _dense_layer_spec(cfg)
    dec = {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn.attention_spec(cfg),
           "ln_x": rmsnorm_spec(cfg.d_model),
           "cross": attn.attention_spec(cfg, cross=True),
           "ln2": rmsnorm_spec(cfg.d_model), "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}
    return enc, dec


def model_spec(cfg: ArchConfig) -> dict:
    check_family(cfg)
    spec: dict[str, Any] = {
        "embed": embed_spec(cfg.vocab, cfg.d_model),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((cfg.d_model, cfg.vocab), ("fsdp", "tp"))
    fam = cfg.family
    if fam in ("dense", "vlm"):
        spec["layers"] = stack_layers(cfg.n_layers, _dense_layer_spec(cfg))
    elif fam == "moe":
        if cfg.first_k_dense:
            spec["dense_layers"] = stack_layers(cfg.first_k_dense,
                                                _dense_layer_spec(cfg))
        spec["layers"] = stack_layers(cfg.n_layers - cfg.first_k_dense,
                                      _moe_layer_spec(cfg))
    elif fam == "ssm":
        spec["layers"] = stack_layers(cfg.n_layers, _mamba_layer_spec(cfg))
    elif fam == "hybrid":
        if cfg.n_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                             f"period blocks of {cfg.attn_period}")
        spec["blocks"] = stack_layers(cfg.n_layers // cfg.attn_period,
                                      _hybrid_block_spec(cfg))
    else:                                   # encdec, audio
        enc, dec = _encdec_layer_specs(cfg)
        spec["enc_layers"] = stack_layers(cfg.enc_layers, enc)
        spec["enc_norm"] = rmsnorm_spec(cfg.d_model)
        spec["layers"] = stack_layers(cfg.n_layers, dec)
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


def encoder_forward(params: dict, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Bidirectional encoder over (stub) frame embeddings (B, Le, d), then
    ``enc_norm``."""
    h = frames
    for i in range(cfg.enc_layers):
        lp = tree_map(lambda a, i=i: a[i], params["enc_layers"])
        h = h + attn.attention_train(lp["attn"], rmsnorm(h, lp["ln1"], cfg.norm_eps),
                                     cfg, causal=False)
        h = h + mlp(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps))
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


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
