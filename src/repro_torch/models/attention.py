"""Attention: GQA with RoPE and optional qk-norm.

The entry points of the reference's ``models/attention.py``:

* ``attention_train``  — full-sequence causal (or bidirectional) attention by
  chunked online softmax over KV chunks; the L x L score matrix is never
  materialised, the live tile is (B, KV, G, q_block, kv_chunk).
* ``attention_prefill`` — causal attention that also returns the K/V cache.
* ``attention_decode`` — one query token against a (B, S, KV, hd) cache.
* ``attention_cross`` — encoder-decoder cross attention (no RoPE, no causal
  mask), chunked; ``cross_cache_from_encoder`` projects the encoder output
  once at prefill, and ``attention_cross_decode`` scores one query against
  that static cache.

Query heads are grouped as (KV, G) and contracted against the raw KV
tensors: K/V are never expanded to H heads.

On a mesh (``ctx``, ``runtime/sharding.py``) the reference's seven
``constrain`` sites place q/k/v on ("batch", None, "tp", None), the
prefill K/V and the decode caches on ("batch", "kv_seq", None, "kv_tp").
The chunked online softmax runs on each rank's (batch, heads) block
(``shd.local``): no collective.  A decode step writes the new row on the
rank that holds ``pos`` (under ``seq_sharded_kv`` the cache's sequence is
sharded over the data axes) and combines the per-shard (max, sum of
exponentials, weighted V) with all-reduces: the log-sum-exp combine the
reference's partitioner derives.  The (B, KV, G, S) scores are never
gathered.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, rmsnorm
from repro_torch.models.params import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import constrain

DEFAULT_Q_BLOCK = 4096


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def attention_spec(cfg: ArchConfig, cross: bool = False) -> dict:
    """A cross-attention block (``cross``) has no qk-norm."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    spec = {
        "wq": ParamSpec((d, h, hd), ("fsdp", "tp", None)),
        "wk": ParamSpec((d, kv, hd), ("fsdp", "tp", None)),
        "wv": ParamSpec((d, kv, hd), ("fsdp", "tp", None)),
        "wo": ParamSpec((h, hd, d), ("tp", None, "fsdp"), fan_in_dims=(0, 1)),
    }
    if cfg.qk_norm and not cross:
        spec["q_norm"] = ParamSpec((hd,), (None,), init="ones")
        spec["k_norm"] = ParamSpec((hd,), (None,), init="ones")
    return spec


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _tp(ctx) -> int:
    """The size of the ``tp`` axes (1 off a mesh)."""
    if not shd.on_mesh(ctx):
        return 1
    return math.prod(ctx.axis_sizes.get(a, 1) for a in ctx.rules.get("tp", ()))


def _replicated_over_tp(fn, x: torch.Tensor, w: torch.Tensor, ctx) -> torch.Tensor:
    """``fn(x, w)`` where the ``tp`` axes do not divide the heads of ``w``
    (2 KV heads over a 4-way ``model`` axis): ``_sanitize`` replicates the
    weight's heads, and the reference's product runs replicated over
    ``tp`` too.  Each rank computes its batch rows' whole product from the
    weight's gathered ``fsdp`` shards.  Left to itself, DTensor's product
    may split the flat (H * hd) dim over ``tp`` (a slice of a replicated
    operand costs nothing), which no head split can carry."""
    why = "a product whose heads the tp axes do not divide runs replicated over tp"
    x = shd.reshard(x, ("batch",) + (None,) * (x.ndim - 1), ctx, why)
    w = shd.reshard(w, (None,) * w.ndim, ctx, why)
    xp, wp = tuple(x.placements), tuple(w.placements)
    return shd.local(fn, ctx, (xp, wp), (xp,), (xp, shd.partial_where(wp, xp, 0)))(x, w)


def _proj(x: torch.Tensor, w: torch.Tensor, ctx=None) -> torch.Tensor:
    """(B, L, d) x (d, H, hd) -> (B, L, H, hd)."""
    d, h, hd = w.shape
    if h % _tp(ctx):
        return _replicated_over_tp(_proj, x, w, ctx)
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def _out(x: torch.Tensor, wo: torch.Tensor, ctx=None) -> torch.Tensor:
    """(B, L, H, hd) x (H, hd, d) -> (B, L, d), as one 2-D product (what
    ``matmul`` folds a contiguous operand into; a DTensor's fold follows
    its local layout, which a redistribution may leave strided)."""
    h, hd, d = wo.shape
    if h % _tp(ctx):
        return _replicated_over_tp(_out, x, wo, ctx)
    b, l = x.shape[:2]
    return (x.reshape(b * l, h * hd) @ wo.reshape(h * hd, d)).reshape(b, l, d)


def _scale(hd: int) -> float:
    """1 / sqrt(hd) rounded to float32, as the reference computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _rounded(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (float32, bfloat16 or float16), to nearest
    even, as ``torch.tensor(x, dtype=dtype).item()`` gives it, without a
    tensor: a traced step (fake tensors, a checkpoint's recompute) cannot
    read one back."""
    if dtype == torch.float16:
        return float(np.float16(np.float32(x)))
    x32 = np.float32(x)
    if dtype == torch.float32:
        return float(x32)
    if dtype != torch.bfloat16:
        raise ValueError(f"no rounding to {dtype}")
    bits = int(x32.view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(bits).view(np.float32))


def _project_qkv(params, x, kv_x, cfg: ArchConfig, ctx, positions, kv_positions,
                 rope: bool):
    q = _proj(x, params["wq"], ctx)
    k = _proj(kv_x, params["wk"], ctx)
    v = _proj(kv_x, params["wv"], ctx)
    if cfg.qk_norm and "q_norm" in params:   # qk-norm before RoPE
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    q = constrain(q, ("batch", None, "tp", None), ctx)
    k = constrain(k, ("batch", None, "tp", None), ctx)
    v = constrain(v, ("batch", None, "tp", None), ctx)
    return q, k, v


# ---------------------------------------------------------------------------
# chunked online-softmax attention (train / prefill)
# ---------------------------------------------------------------------------

def _chunked_attention(q, k, v, *, causal: bool, q_offset: int,
                       kv_chunk: int, bf16_intermediates: bool = False,
                       q_block: int = DEFAULT_Q_BLOCK) -> torch.Tensor:
    """q: (B, Lq, H, hd), k/v: (B, Lk, KV, hd), grouped GQA.

    The query axis is split into ``q_block`` tiles, and each tile
    online-softmax-scans only the KV chunks it can causally see: fully
    masked (tile, chunk) pairs are never computed.  The running max and sum
    and the output accumulator stay float32; ``bf16_intermediates`` makes
    the scores and probabilities bfloat16.
    """
    b, lq, h, hd = q.shape
    lk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    kv_chunk = min(kv_chunk, lk)
    n_chunks = -(-lk // kv_chunk)
    pad = n_chunks * kv_chunk - lk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    cdt = torch.bfloat16 if bf16_intermediates else torch.float32
    scale = _rounded(_scale(hd), cdt)
    qt = (q.to(cdt) * scale).reshape(b, lq, n_kv, g, hd).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1).to(cdt)                              # (B,KV,hd,Lk)
    vt = v.permute(0, 2, 1, 3).to(cdt)                              # (B,KV,Lk,hd)
    kt = kt.reshape(b, n_kv, hd, n_chunks, kv_chunk).permute(3, 0, 1, 2, 4)
    vt = vt.reshape(b, n_kv, n_chunks, kv_chunk, hd).permute(2, 0, 1, 3, 4)
    dev = q.device

    def attend_tile(q_tile, tile_start, tile_len, n_vis):
        """q_tile: (B,KV,G,tile_len,hd); scans its n_vis visible KV chunks."""
        q_rows = q_tile.reshape(b, n_kv, g * tile_len, hd)
        q_pos = q_offset + tile_start + torch.arange(tile_len, device=dev)
        m = torch.full((b, n_kv, g, tile_len), float("-inf"), device=dev)
        s = torch.zeros((b, n_kv, g, tile_len), device=dev)
        acc = torch.zeros((b, n_kv, g, tile_len, hd), device=dev)
        for idx in range(n_vis):
            scores = (q_rows @ kt[idx]).view(b, n_kv, g, tile_len, kv_chunk)  # cdt
            kv_pos = idx * kv_chunk + torch.arange(kv_chunk, device=dev)
            if causal:
                mask = kv_pos[None, :] <= q_pos[:, None]
            else:
                mask = torch.ones((tile_len, kv_chunk), dtype=torch.bool, device=dev)
            mask = mask & (kv_pos < lk)[None, :]                     # padding
            sc = torch.where(mask, scores.float(), float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            # guard fully-masked rows (m == -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(sc - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            fin = torch.isfinite(m)
            corr = torch.where(fin, torch.exp(torch.where(fin, m - m_safe, 0.0)), 0.0)
            s = s * corr + p.sum(dim=-1)
            # products of cdt operands, accumulated and kept in float32
            pv = p.to(cdt).float().reshape(b, n_kv, g * tile_len, kv_chunk) @ vt[idx].float()
            acc = acc * corr[..., None] + pv.view(b, n_kv, g, tile_len, hd)
            m = m_new
        return acc / torch.clamp(s, min=1e-30)[..., None]

    q_block = min(q_block, lq)
    n_qb = -(-lq // q_block)
    outs = []
    for i in range(n_qb):
        start = i * q_block
        tl = min(q_block, lq - start)
        if causal:
            n_vis = min(n_chunks, -(-(q_offset + start + tl) // kv_chunk))
        else:
            n_vis = n_chunks
        outs.append(attend_tile(qt[:, :, :, start:start + tl], start, tl, max(n_vis, 1)))
    out = torch.cat(outs, dim=3) if n_qb > 1 else outs[0]
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, hd).to(q.dtype)


def _attend_chunks(q, k, v, cfg: ArchConfig, ctx, *, causal: bool,
                   kv_chunk: int | None) -> torch.Tensor:
    """``_chunked_attention`` (from position 0) of q (B, Lq, H, hd) over
    k/v (B, Lk, KV, hd); on a mesh on each rank's (batch, heads) block,
    which needs no collective: a block of H/M query heads reads the block
    of KV/M heads of its group.  Where the ``tp`` axes do not divide the KV
    heads, K/V are replicated over them (``_proj``) and each rank reads the
    KV head of each of its query heads, as the reference's partitioner
    computes q's head shards against replicated K/V."""
    kw = dict(causal=causal, q_offset=0, kv_chunk=kv_chunk or cfg.attn_kv_chunk,
              bf16_intermediates=cfg.attn_bf16_intermediates)
    if not shd.on_mesh(ctx):
        return _chunked_attention(q, k, v, **kw)
    qp, kp = tuple(q.placements), tuple(k.placements)
    if [p == Shard(2) for p in qp] == [p == Shard(2) for p in kp]:
        return shd.local(lambda q_, k_, v_: _chunked_attention(q_, k_, v_, **kw), ctx,
                         (qp, kp, kp), (qp,))(q, k, v)
    block, _ = shd.shard_block(qp, 2, ctx)
    h_loc = q.shape[2] // shd.shard_count(qp, 2, ctx)
    g = q.shape[2] // k.shape[2]
    heads = [(block * h_loc + i) // g for i in range(h_loc)]
    # a non-decreasing run of KV heads: each head with its query heads' count,
    # gathered from views, so no index tensor goes to the device
    runs = [(j, heads.count(j)) for j in range(heads[0], heads[-1] + 1)]

    def pick(t):
        return torch.cat([t[:, :, j:j + 1].expand(-1, -1, n, -1) for j, n in runs], dim=2)

    def attend(q_, k_, v_):
        return _chunked_attention(q_, pick(k_), pick(v_), **kw)

    kg = shd.partial_where(kp, qp, 2)    # each rank's KV heads get its heads' gradient
    return shd.local(attend, ctx, (qp, kp, kp), (qp,), (qp, kg, kg))(q, k, v)


def attention_train(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None, *,
                    causal: bool = True, kv_chunk: int | None = None) -> torch.Tensor:
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(params, x, x, cfg, ctx, positions, positions, True)
    out = _attend_chunks(q, k, v, cfg, ctx, causal=causal, kv_chunk=kv_chunk)
    return _out(out, params["wo"], ctx)


def attention_cross(params: dict, x: torch.Tensor, enc_out: torch.Tensor,
                    cfg: ArchConfig, ctx=None, *, kv_chunk: int | None = None
                    ) -> torch.Tensor:
    """Queries from x (B, Lq, d) over keys and values of ``enc_out``
    (B, Lk, d): no RoPE, no mask."""
    q, k, v = _project_qkv(params, x, enc_out, cfg, ctx, None, None, False)
    out = _attend_chunks(q, k, v, cfg, ctx, causal=False, kv_chunk=kv_chunk)
    return _out(out, params["wo"], ctx)


# ---------------------------------------------------------------------------
# prefill (returns the KV cache) and single-token decode
# ---------------------------------------------------------------------------

def attention_prefill(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None, *,
                      kv_chunk: int | None = None):
    """Causal attention that also returns the (B, L, KV, hd) cache."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _project_qkv(params, x, x, cfg, ctx, positions, positions, True)
    out = _attend_chunks(q, k, v, cfg, ctx, causal=True, kv_chunk=kv_chunk)
    k = constrain(k, ("batch", "kv_seq", None, "kv_tp"), ctx)
    v = constrain(v, ("batch", "kv_seq", None, "kv_tp"), ctx)
    return _out(out, params["wo"], ctx), (k, v)


def attention_decode(params: dict, x: torch.Tensor, cache: tuple, pos: int,
                     cfg: ArchConfig, ctx=None) -> tuple[torch.Tensor, tuple]:
    """x: (B, 1, d); cache: (k, v) each (B, S, KV, hd); pos: the position
    of the token (a Python int).

    Writes the token's K/V into the cache at ``pos`` in place and returns
    the caches with the output; scores the whole cache length S in float32
    under the mask ``arange(S) <= pos``.  A cache whose S is sharded (the
    ``seq_sharded_kv`` rules) is written on the rank that holds ``pos``
    and attended by the log-sum-exp combine (``_attend_sharded``).
    """
    b = x.shape[0]
    k_cache, v_cache = cache
    s = k_cache.shape[1]
    if not 0 <= pos < s:
        raise IndexError(f"decode position {pos} outside the cache's {s} positions")
    q = _proj(x, params["wq"], ctx)
    k_new = _proj(x, params["wk"], ctx)
    v_new = _proj(x, params["wv"], ctx)
    if cfg.qk_norm and "q_norm" in params:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k_new = rmsnorm(k_new, params["k_norm"], cfg.norm_eps)
    positions = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    _write_row(k_cache, pos, k_new, ctx)
    _write_row(v_cache, pos, v_new, ctx)
    k_cache = constrain(k_cache, ("batch", "kv_seq", None, "kv_tp"), ctx)
    v_cache = constrain(v_cache, ("batch", "kv_seq", None, "kv_tp"), ctx)

    if shd.on_mesh(ctx):
        out = _attend_sharded(q, k_cache, v_cache, pos, cfg, ctx)
    else:
        scores = _grouped_scores(q, k_cache, cfg)
        mask = torch.arange(s, device=x.device) <= pos   # scores: (B, KV, G, S)
        out = _attend_cache(torch.where(mask, scores, float("-inf")), v_cache)
        out = out.reshape(b, 1, cfg.n_heads, -1)
    return _out(out.to(x.dtype), params["wo"], ctx), (k_cache, v_cache)


def _write_row(cache: torch.Tensor, pos: int, new: torch.Tensor, ctx) -> None:
    """``cache[:, pos] = new`` in place.  On a mesh the row takes the
    cache's placements (its sequence dim, of length 1, replicated) and the
    rank whose block of S holds ``pos`` writes it into its local part: no
    rank gathers the cache."""
    new = new.to(cache.dtype)
    if not shd.on_mesh(ctx):
        cache[:, pos:pos + 1] = new
        return
    new = shd.reshard(new, ("batch", None, None, "kv_tp"), ctx,
                      "the new row takes the cache's batch and hd shards")
    row = tuple(new.placements)
    block, _ = shd.shard_block(tuple(cache.placements), 1, ctx)

    def write(c, n):
        start = block * c.shape[1]
        if start <= pos < start + c.shape[1]:
            c[:, pos - start:pos - start + 1] = n
        return c

    shd.local(write, ctx, (cache.placements, row), (cache.placements,))(cache, new)


def _attend_sharded(q, k_cache, v_cache, pos: int, cfg: ArchConfig, ctx):
    """One query against a placed cache, positions past ``pos`` masked:
    each rank scores its block of S (all of S unless ``kv_seq`` shards it)
    with the partial dot products over its hd slice (``kv_tp``) summed
    over the hd ranks, and the blocks' (max, sum of exp, weighted V)
    combine by all-reduces over the S ranks: the softmax of the whole row,
    never gathered.  -> (B, 1, H, hd) float32 on head shards, for ``wo``."""
    b = q.shape[0]
    hd, n_kv = cfg.resolved_head_dim, cfg.n_kv_heads
    g = cfg.n_heads // n_kv
    kp = tuple(k_cache.placements)
    # q's hd placed as the cache's hd (kv_tp), its heads whole (a block of
    # H / tp heads need not be whole KV groups), then grouped (B, KV, G, hd)
    q = shd.reshard(q, ("batch", None, None, "kv_tp"), ctx,
                    "the query meets the cache's hd shards (kv_tp)")
    qg = q.reshape(b, n_kv, g, hd)
    block, s_axes = shd.shard_block(kp, 1, ctx)
    tp_axes = shd.shard_block(kp, 3, ctx)[1]
    s_groups = [ctx.mesh.get_group(a) for a in s_axes]
    tp_groups = [ctx.mesh.get_group(a) for a in tp_axes]
    scale = _scale(hd)

    def attend(qg, kc, vc):
        s_loc = kc.shape[1]
        scores = (qg.float() * scale) @ kc.float().permute(0, 2, 3, 1)   # (B,KV,G,S_loc)
        for grp in tp_groups:
            scores = shd.sum_over(scores, grp)
        kv_pos = block * s_loc + torch.arange(s_loc, device=kc.device)
        scores = torch.where(kv_pos <= pos, scores, float("-inf"))
        m = scores.amax(dim=-1, keepdim=True)
        for grp in s_groups:
            m = shd.max_over(m, grp)
        p = torch.exp(scores - m)              # a block past pos: all zeros
        tot = p.sum(dim=-1, keepdim=True)
        out = p @ vc.float().permute(0, 2, 1, 3)                          # (B,KV,G,hd_loc)
        for grp in s_groups:
            tot = shd.sum_over(tot, grp)
            out = shd.sum_over(out, grp)
        out = out / tot                                    # (B_loc, KV, G, hd_loc)
        return out.reshape(out.shape[0], 1, n_kv * g, -1)

    out_pl = [Shard(3) if p == Shard(3) else (p if p == Shard(0) else Replicate())
              for p in kp]
    out = shd.local(attend, ctx, (tuple(qg.placements), kp, tuple(v_cache.placements)),
                    (out_pl,))(qg, k_cache, v_cache)
    return shd.reshard(out, ("batch", None, "tp", None), ctx,
                       "the decode output goes from the cache's hd shards to head shards "
                       "for wo")


def _grouped_scores(q: torch.Tensor, k_cache: torch.Tensor, cfg: ArchConfig):
    """One query token (B, 1, H, hd) against a (B, S, KV, hd) cache ->
    float32 scores (B, KV, G, S).  q is promoted to float32 before its
    scale, as a bf16 x f32 product is in the reference."""
    hd, n_kv = cfg.resolved_head_dim, cfg.n_kv_heads
    qg = q.reshape(q.shape[0], n_kv, cfg.n_heads // n_kv, hd)  # grouped, no KV expand
    return (qg.float() * _scale(hd)) @ k_cache.float().permute(0, 2, 3, 1)


def _attend_cache(scores: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """Softmax of float32 scores (B, KV, G, S) over a (B, S, KV, hd) cache
    -> (B, KV, G, hd) float32."""
    return torch.softmax(scores, dim=-1) @ v_cache.float().permute(0, 2, 1, 3)


def attention_cross_decode(params: dict, x: torch.Tensor, cross_cache: tuple,
                           cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Decode-time cross attention: the query of x (B, 1, d) over the static
    (k, v) cache made from the encoder output at prefill, scored in float32
    over every encoder position."""
    k_cache, v_cache = cross_cache
    q = _proj(x, params["wq"], ctx)
    if shd.on_mesh(ctx):
        out = _attend_sharded(q, k_cache, v_cache, k_cache.shape[1] - 1, cfg, ctx)
    else:
        out = _attend_cache(_grouped_scores(q, k_cache, cfg), v_cache)
        out = out.reshape(x.shape[0], 1, cfg.n_heads, -1)
    return _out(out.to(x.dtype), params["wo"], ctx)


def cross_cache_from_encoder(params: dict, enc_out: torch.Tensor, ctx=None) -> tuple:
    """The static cross-attention (k, v) cache, (B, Le, KV, hd) each,
    projected once at prefill."""
    return _proj(enc_out, params["wk"], ctx), _proj(enc_out, params["wv"], ctx)
