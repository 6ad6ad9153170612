"""Serving paths: prefill (build the caches) and single-token decode.

Cache layouts (stacked over layers, as the reference's):

  dense/vlm : {"k","v"}           (n_layers, B, S, KV, hd)
  moe       : {"dense": {...}, "moe": {...}} per sub-stack
  ssm       : {"ssm", "conv"}     (n_layers, B, di, st) float32 /
                                  (n_layers, B, k-1, di)
  hybrid    : {"k","v"} (n_blocks, B, S, KV, hd) for each period block's
              attention sublayer + {"ssm","conv"} (n_blocks, p-1, B, ...)
              for its mamba sublayers
  encdec    : {"k","v"} decoder self-attention (n_layers, B, S, KV, hd) +
  audio       {"ck","cv"} static cross caches (n_layers, B, enc_len, KV, hd)

Both functions run under ``torch.inference_mode()`` (``torch.no_grad()``
on a mesh: a DTensor's views refuse inference tensors).  ``decode_step``
writes the new token's K/V and the new SSM and conv states into the
caches in place and returns them; the cross caches are left as they are.

On a mesh (``ctx``) the caches are placed by ``cache_axes`` (the
reference's ``cache_shardings``: K/V on (None, "batch", "kv_seq", None,
"kv_tp"), the SSM state on ("batch", "tp", None), the conv tail on
("batch", None, "tp")), and the reference's fourteen ``constrain`` sites
place the residual stream, the padded prefill caches and the logits.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import embed, mlp, rmsnorm, unembed
from repro_torch.models.model import check_family, embed_inputs, encoder_forward
from repro_torch.models.params import flatten, tree_map
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import constrain


# ===========================================================================
# cache structure
# ===========================================================================

def _kv_struct(cfg: ArchConfig, n: int, batch: int, seq: int, dtype, device):
    hd = cfg.resolved_head_dim
    return torch.zeros((n, batch, seq, cfg.n_kv_heads, hd), dtype=dtype, device=device)


def cache_axes(name: str, rank: int) -> tuple:
    """The logical axes of a cache leaf by its name and rank (the
    reference's ``cache_shardings`` rule)."""
    if name in ("k", "v", "ck", "cv"):           # (n, B, S, KV, hd)
        return (None, "batch", "kv_seq", None, "kv_tp")
    if name == "ssm":                            # (..., B, di, st)
        return (None,) * (rank - 3) + ("batch", "tp", None)
    if name == "conv":                           # (..., B, k-1, di)
        return (None,) * (rank - 3) + ("batch", None, "tp")
    return (None,) * rank


def cache_shardings(cache_tree: dict, ctx) -> dict:
    """A cache tree's ``Sharding``s by ``cache_axes`` (None leaves without
    a mesh): the reference's ``runtime/steps.py::cache_shardings``."""
    def one(tree, name=""):
        if isinstance(tree, dict):
            return {k: one(v, k) for k, v in tree.items()}
        return shd.sharding_for(cache_axes(name, tree.dim()), ctx, tuple(tree.shape))
    return one(cache_tree)


def place_caches(caches: dict, ctx) -> dict:
    """Caches placed by ``cache_shardings`` (as they are without a mesh;
    a leaf already placed so is kept, so in-place writes reach it)."""
    if not shd.on_mesh(ctx):
        return caches
    return tree_map(shd.place, caches, cache_shardings(caches, ctx))


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype: torch.dtype,
                device=None, enc_len: int = 0, ctx=None) -> dict:
    """Zero caches of length ``seq`` (cross caches of ``enc_len``) on
    ``device`` (default: the card; ``"meta"`` allocates nothing), placed
    by ``cache_axes`` on ``ctx``'s mesh."""
    check_family(cfg)
    dev = resolve_device(device)
    return place_caches(_zero_caches(cfg, batch, seq, dtype, dev, enc_len), ctx)


def _zero_caches(cfg: ArchConfig, batch: int, seq: int, dtype: torch.dtype, dev,
                 enc_len: int) -> dict:

    def kv(n, seq=seq, names=("k", "v")):
        return {name: _kv_struct(cfg, n, batch, seq, dtype, dev) for name in names}

    def mamba(*lead):
        return mb.mamba_init_state(cfg, batch, dtype, dev, lead)

    fam = cfg.family
    if fam in ("dense", "vlm"):
        return kv(cfg.n_layers)
    if fam == "moe":
        out = {"moe": kv(cfg.n_layers - cfg.first_k_dense)}
        if cfg.first_k_dense:
            out["dense"] = kv(cfg.first_k_dense)
        return out
    if fam == "ssm":
        return mamba(cfg.n_layers)
    if fam == "hybrid":
        nb = cfg.n_layers // cfg.attn_period
        return {**kv(nb), **mamba(nb, cfg.attn_period - 1)}
    return {**kv(cfg.n_layers), **kv(cfg.n_layers, enc_len, ("ck", "cv"))}


def _pad_cache(k: torch.Tensor, v: torch.Tensor, seq: int, ctx=None):
    """Grow (B, L, KV, hd) prefill K/V to the full (B, seq, KV, hd) cache."""
    pad = seq - k.shape[1]
    if pad > 0:
        why = "padding moves a sharded sequence's blocks (a no-op unless kv_seq shards)"
        k = shd.reshard(k, ("batch", None, None, "kv_tp"), ctx, why)
        v = shd.reshard(v, ("batch", None, None, "kv_tp"), ctx, why)
        k = shd.pad(k, (0, 0, 0, 0, 0, pad), ctx)
        v = shd.pad(v, (0, 0, 0, 0, 0, pad), ctx)
    k = constrain(k, ("batch", "kv_seq", None, "kv_tp"), ctx)
    v = constrain(v, ("batch", "kv_seq", None, "kv_tp"), ctx)
    return k, v


def _layers(stacked: dict) -> list[dict]:
    """A stacked layer tree -> one tree of views per layer."""
    n = next(iter(flatten(stacked).values())).shape[0]
    return [tree_map(lambda a, i=i: a[i], stacked) for i in range(n)]


def _ffn(lp: dict, h: torch.Tensor, cfg: ArchConfig, ctx, ln: str = "ln2") -> torch.Tensor:
    """The layer's FFN half: a dense MLP or the MoE layer, with its residual."""
    hn = rmsnorm(h, lp[ln], cfg.norm_eps)
    if "mlp" in lp:
        return h + mlp(lp["mlp"], hn, ctx)
    out, _ = moe_mod.moe_layer(lp["moe"], hn, cfg, ctx)
    return h + out


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(table, x, tied=cfg.tie_embeddings)


def _sub_stacks(cfg: ArchConfig) -> list[tuple[str | None, str]]:
    """(cache key, params key) of each attention layer stack of a dense,
    vlm or moe model, in the order they run; a dense or vlm model has one
    stack and flat caches."""
    if cfg.family in ("dense", "vlm"):
        return [(None, "layers")]
    return ([("dense", "dense_layers")] if cfg.first_k_dense else []) + [("moe", "layers")]


def _hybrid_block(bp: dict, h: torch.Tensor, cfg: ArchConfig, ctx, attention, mamba,
                  settle) -> torch.Tensor:
    """One Jamba period block: sublayer 0 is ``attention(params, hn)``,
    sublayer j > 0 is ``mamba(j - 1, params, hn)`` (each returns what is
    added to the residual), and each sublayer is followed by the next MLP
    at even j and the next MoE at odd j, then by ``settle(h)`` (the
    caller's placement of the residual)."""
    mambas, mlps, moes = _layers(bp["mamba"]), _layers(bp["mlp"]), _layers(bp["moe"])
    for j in range(cfg.attn_period):
        if j == 0:
            sub = bp["attn"]
            h = h + attention(sub["attn"], rmsnorm(h, sub["ln"], cfg.norm_eps))
        else:
            sub = mambas[j - 1]
            h = h + mamba(j - 1, sub["mamba"], rmsnorm(h, sub["ln"], cfg.norm_eps))
        h = settle(_ffn(moes[j // 2] if j % 2 else mlps[j // 2], h, cfg, ctx, ln="ln"))
    return h


def _mamba_decode(p: dict, hn: torch.Tensor, state: dict, cfg: ArchConfig, ctx):
    """A mamba sublayer's decode step, its ``state`` tensors (views of the
    caches) written in place; returns what is added to the residual."""
    out, new = mb.mamba_decode(p, hn, state, cfg, ctx)
    why = "the new state takes its cache's placement (a no-op on the decode path)"
    state["ssm"].copy_(shd.reshard(new["ssm"], ("batch", "tp", None), ctx, why))
    state["conv"].copy_(shd.reshard(new["conv"], ("batch", None, "tp"), ctx, why))
    return out


# ===========================================================================
# prefill
# ===========================================================================

def _no_grad(ctx):
    """``inference_mode`` on one card, ``no_grad`` on a mesh."""
    return torch.inference_mode() if not shd.on_mesh(ctx) else torch.no_grad()


def prefill(params: dict, batch: dict, cfg: ArchConfig,
            cache_seq: int, ctx=None) -> tuple[torch.Tensor, dict]:
    """Run the full prompt, return (last-position logits (B, V), caches).

    batch: tokens (B, L) [, media (B, M, d) | frames (B, Le, d)]."""
    check_family(cfg)
    with _no_grad(ctx), shd.replicated(ctx):
        return _prefill(params, batch, cfg, cache_seq, ctx)


def _prefill(params, batch, cfg, cache_seq, ctx):
    dtype = getattr(torch, cfg.dtype)
    x = constrain(embed_inputs(params, batch, cfg, ctx), ("batch", None, None), ctx)
    fam = cfg.family
    caches: dict = {}

    def attend(p, hn, ks, vs):
        a, (k, v) = attn.attention_prefill(p, hn, cfg, ctx)
        kp, vp = _pad_cache(k, v, cache_seq, ctx)
        ks.append(kp.to(dtype))
        vs.append(vp.to(dtype))
        return a

    if fam in ("dense", "vlm", "moe"):
        for cache_key, params_key in _sub_stacks(cfg):
            ks, vs = [], []
            for lp in _layers(params[params_key]):
                x = x + attend(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), ks, vs)
                x = constrain(_ffn(lp, x, cfg, ctx), ("batch", None, None), ctx)
            kv = {"k": torch.stack(ks), "v": torch.stack(vs)}
            if cache_key is None:
                caches = kv
            else:
                caches[cache_key] = kv
    elif fam == "ssm":
        ssm, conv = [], []
        for lp in _layers(params["layers"]):
            out, st = mb.mamba_prefill(lp["mamba"], rmsnorm(x, lp["ln"], cfg.norm_eps), cfg,
                                       ctx)
            x = constrain(x + out, ("batch", None, None), ctx)
            ssm.append(st["ssm"])
            conv.append(st["conv"].to(dtype))
        caches = {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}
    elif fam == "hybrid":
        ks, vs, ssm, conv = [], [], [], []
        for bp in _layers(params["blocks"]):
            states = []

            def mamba(j, p, hn, states=states):
                out, st = mb.mamba_prefill(p, hn, cfg, ctx)
                states.append(st)
                return out

            x = _hybrid_block(bp, x, cfg, ctx, lambda p, hn: attend(p, hn, ks, vs), mamba,
                              lambda h: constrain(h, ("batch", None, None), ctx))
            ssm.append(torch.stack([st["ssm"] for st in states]))
            conv.append(torch.stack([st["conv"] for st in states]).to(dtype))
        caches = {"k": torch.stack(ks), "v": torch.stack(vs),
                  "ssm": torch.stack(ssm), "conv": torch.stack(conv)}
    else:                                           # encdec, audio
        enc_out = encoder_forward(params, batch["frames"].to(dtype), cfg, ctx)
        ks, vs, cks, cvs = [], [], [], []
        for lp in _layers(params["layers"]):
            x = x + attend(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), ks, vs)
            x = x + attn.attention_cross(lp["cross"], rmsnorm(x, lp["ln_x"], cfg.norm_eps),
                                         enc_out, cfg, ctx)
            x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), ctx)
            x = constrain(x, ("batch", None, None), ctx)
            ck, cv = attn.cross_cache_from_encoder(lp["cross"], enc_out, ctx)
            cks.append(ck.to(dtype))
            cvs.append(cv.to(dtype))
        caches = {"k": torch.stack(ks), "v": torch.stack(vs),
                  "ck": torch.stack(cks), "cv": torch.stack(cvs)}
    return constrain(_logits(params, x[:, -1], cfg), ("batch", "tp"), ctx), caches


# ===========================================================================
# decode
# ===========================================================================

def decode_step(params: dict, tokens: torch.Tensor, caches: dict, pos: int,
                cfg: ArchConfig, ctx=None) -> tuple[torch.Tensor, dict]:
    """tokens: (B, 1) at position ``pos`` -> (logits (B, V), caches updated
    in place)."""
    check_family(cfg)
    with _no_grad(ctx), shd.replicated(ctx):
        return _decode_step(params, tokens, caches, pos, cfg, ctx)


def _decode_step(params, tokens, caches, pos, cfg, ctx):
    x = constrain(embed(params["embed"], tokens, ctx), ("batch", None, None), ctx)
    fam = cfg.family

    def attend(p, hn, kv, i):
        a, _ = attn.attention_decode(p, hn, (kv["k"][i], kv["v"][i]), pos, cfg, ctx)
        return a

    if fam in ("dense", "vlm", "moe"):
        for cache_key, params_key in _sub_stacks(cfg):
            kv = caches if cache_key is None else caches[cache_key]
            for i, lp in enumerate(_layers(params[params_key])):
                x = x + attend(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), kv, i)
                x = constrain(_ffn(lp, x, cfg, ctx), ("batch", None, None), ctx)
    elif fam == "ssm":
        for i, lp in enumerate(_layers(params["layers"])):
            state = {"ssm": caches["ssm"][i], "conv": caches["conv"][i]}
            x = x + _mamba_decode(lp["mamba"], rmsnorm(x, lp["ln"], cfg.norm_eps), state, cfg,
                                  ctx)
            x = constrain(x, ("batch", None, None), ctx)
    elif fam == "hybrid":
        for b, bp in enumerate(_layers(params["blocks"])):
            x = _hybrid_block(
                bp, x, cfg, ctx, lambda p, hn, b=b: attend(p, hn, caches, b),
                lambda j, p, hn, b=b: _mamba_decode(
                    p, hn, {"ssm": caches["ssm"][b, j], "conv": caches["conv"][b, j]}, cfg,
                    ctx),
                lambda h: constrain(h, ("batch", None, None), ctx))
    else:                                           # encdec, audio
        for i, lp in enumerate(_layers(params["layers"])):
            x = x + attend(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), caches, i)
            x = x + attn.attention_cross_decode(
                lp["cross"], rmsnorm(x, lp["ln_x"], cfg.norm_eps),
                (caches["ck"][i], caches["cv"][i]), cfg, ctx)
            x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), ctx)
            x = constrain(x, ("batch", None, None), ctx)
    return constrain(_logits(params, x[:, 0], cfg), ("batch", "tp"), ctx), caches
