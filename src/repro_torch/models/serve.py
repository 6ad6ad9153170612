"""Serving paths: prefill (build the KV caches) and single-token decode.

Cache layouts (stacked over layers, as the reference's):

  dense/vlm : {"k","v"}           (n_layers, B, S, KV, hd)
  moe       : {"dense": {...}, "moe": {...}} per sub-stack

Both functions run under ``torch.inference_mode()``.  ``decode_step``
writes the new token's K/V into the caches in place and returns them.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import embed, mlp, rmsnorm, unembed
from repro_torch.models.model import check_family, embed_inputs
from repro_torch.models.params import flatten, tree_map


# ===========================================================================
# cache structure
# ===========================================================================

def _kv_struct(cfg: ArchConfig, n: int, batch: int, seq: int, dtype, device):
    hd = cfg.resolved_head_dim
    return torch.zeros((n, batch, seq, cfg.n_kv_heads, hd), dtype=dtype, device=device)


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype: torch.dtype,
                device=None) -> dict:
    """Zero caches of length ``seq`` on ``device`` (default: the card;
    ``"meta"`` allocates nothing)."""
    check_family(cfg)
    dev = resolve_device(device)

    def kv(n):
        return {"k": _kv_struct(cfg, n, batch, seq, dtype, dev),
                "v": _kv_struct(cfg, n, batch, seq, dtype, dev)}

    if cfg.family in ("dense", "vlm"):
        return kv(cfg.n_layers)
    out = {"moe": kv(cfg.n_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        out["dense"] = kv(cfg.first_k_dense)
    return out


def _pad_cache(k: torch.Tensor, v: torch.Tensor, seq: int):
    """Grow (B, L, KV, hd) prefill K/V to the full (B, seq, KV, hd) cache."""
    pad = seq - k.shape[1]
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return k, v


def _layers(stacked: dict) -> list[dict]:
    """A stacked layer tree -> one tree of views per layer."""
    n = next(iter(flatten(stacked).values())).shape[0]
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def _ffn(lp: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The layer's FFN half: a dense MLP or the MoE layer, with its residual."""
    hn = rmsnorm(h, lp["ln2"], cfg.norm_eps)
    if "mlp" in lp:
        return h + mlp(lp["mlp"], hn)
    out, _ = moe_mod.moe_layer(lp["moe"], hn, cfg)
    return h + out


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(table, x, tied=cfg.tie_embeddings)


def _sub_stacks(cfg: ArchConfig) -> list[tuple[str | None, str]]:
    """(cache key, params key) of each layer stack, in the order they run;
    a dense or vlm model has one stack and flat caches."""
    if cfg.family in ("dense", "vlm"):
        return [(None, "layers")]
    return ([("dense", "dense_layers")] if cfg.first_k_dense else []) + [("moe", "layers")]


# ===========================================================================
# prefill
# ===========================================================================

@torch.inference_mode()
def prefill(params: dict, batch: dict, cfg: ArchConfig,
            cache_seq: int) -> tuple[torch.Tensor, dict]:
    """Run the full prompt, return (last-position logits (B, V), caches).

    batch: tokens (B, L) [, media (B, M, d)]."""
    check_family(cfg)
    dtype = getattr(torch, cfg.dtype)
    x = embed_inputs(params, batch, cfg)
    caches: dict = {}
    for cache_key, params_key in _sub_stacks(cfg):
        ks, vs = [], []
        for lp in _layers(params[params_key]):
            a, (k, v) = attn.attention_prefill(
                lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg)
            x = _ffn(lp, x + a, cfg)
            kp, vp = _pad_cache(k, v, cache_seq)
            ks.append(kp.to(dtype))
            vs.append(vp.to(dtype))
        kv = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if cache_key is None:
            caches = kv
        else:
            caches[cache_key] = kv
    return _logits(params, x[:, -1], cfg), caches


# ===========================================================================
# decode
# ===========================================================================

@torch.inference_mode()
def decode_step(params: dict, tokens: torch.Tensor, caches: dict, pos: int,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) at position ``pos`` -> (logits (B, V), caches updated
    in place)."""
    check_family(cfg)
    x = embed(params["embed"], tokens)
    for cache_key, params_key in _sub_stacks(cfg):
        kv = caches if cache_key is None else caches[cache_key]
        for i, lp in enumerate(_layers(params[params_key])):
            a, _ = attn.attention_decode(
                lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps),
                (kv["k"][i], kv["v"][i]), pos, cfg)
            x = _ffn(lp, x + a, cfg)
    return _logits(params, x[:, 0], cfg), caches
