"""Mixture-of-Experts layer: token-choice top-k routing.

Three dispatch implementations, as in the reference's ``models/moe.py``:

* ``dense`` — every expert processes every token, outputs combined with the
  (mostly zero) router weights.
* ``index`` — tokens sorted by expert id (a stable sort: the order decides
  which routed tokens fall past capacity), capacity-sliced into a dense
  (E, cap, d) block, one batched product per expert weight, scattered back
  with the router weights.  Routed tokens past ``cap`` land in an overflow
  row and contribute nothing.  Every expert's weights are read whatever
  the batch: the (E, cap, d) block meets all E experts.
* ``local_index`` — the index dispatch run per data-parallel shard with a
  local capacity: tokens reshaped to (n_dp, T_loc, d), each shard sorted,
  capacity-sliced and scattered back on its own (``_local_build``,
  ``_local_gather_back``, functions over the leading n_dp axis).  Without a
  mesh n_dp = 1, as in the reference; over a mesh n_dp is the product of
  the batch axes' sizes, the leading axis is sharded over them, and the
  sort, the queue positions and the scatters run on each rank's own shard
  (``shd.local``).  The dispatch block then moves from ("batch", None,
  None, None) to ("batch", "tp", None, None): the all-to-all expert
  parallelism needs, and the one the reference names; the expert
  outputs come back by the reverse all-to-all.

On a mesh the ``index`` dispatch sorts all tokens of the batch jointly, as
the reference's does: its tokens, weights and ids are replicated first
(the reference's partitioner gathers them for its global sort), and its
expert outputs are gathered for the scatter-back.

Router: softmax over experts, top-k (ties to the lower expert id, as
``jax.lax.top_k``), weights renormalised over the selected experts, and a
Switch-style load-balance loss returned to the caller.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import mlp, mlp_spec
from repro_torch.models.params import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import constrain


def moe_spec(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    eff = cfg.moe_d_ff or cfg.d_ff
    spec = {
        "router": ParamSpec((d, cfg.n_experts), ("fsdp", None), init="small"),
        "w_gate": ParamSpec((cfg.n_experts, d, eff), ("tp", "fsdp", None),
                            fan_in_dims=(1,)),
        "w_up": ParamSpec((cfg.n_experts, d, eff), ("tp", "fsdp", None),
                          fan_in_dims=(1,)),
        "w_down": ParamSpec((cfg.n_experts, eff, d), ("tp", None, "fsdp"),
                            fan_in_dims=(1,)),
    }
    if cfg.n_shared_experts:
        spec["shared"] = mlp_spec(d, cfg.n_shared_experts * eff)
    return spec


def _route(params, x_flat: torch.Tensor, cfg: ArchConfig):
    """x_flat: (T, d) -> (weights (T, k), ids (T, k), aux_loss).

    The router product runs in the activation dtype and is then taken to
    float32.  The top k come from a stable descending sort, so equal
    probabilities (frequent in bfloat16) order by expert id as
    ``jax.lax.top_k`` orders them; ``torch.topk`` promises no order."""
    logits = (x_flat @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    weights, ids = srt[:, :k], idx[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    density = F.one_hot(ids, cfg.n_experts).float().mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(density * probs.mean(dim=0))
    return weights.to(x_flat.dtype), ids, aux


def _experts_dense(params, x_flat: torch.Tensor, weights, ids,
                   cfg: ArchConfig) -> torch.Tensor:
    """Naive: all experts on all tokens, weighted combine."""
    combine = torch.zeros((x_flat.shape[0], cfg.n_experts), dtype=x_flat.dtype,
                          device=x_flat.device).scatter_add(1, ids, weights)
    h = F.silu(x_flat @ params["w_gate"]) * (x_flat @ params["w_up"])   # (E, T, f)
    outs = h @ params["w_down"]                                          # (E, T, d)
    return torch.einsum("etd,te->td", outs, combine)


def _index_build(x_flat: torch.Tensor, weights, ids, e: int, cap: int) -> tuple:
    """The index dispatch block: routed token indices sorted by expert
    (stable), each one's place in its expert's queue (its index in the
    sorted list less its expert's first index: no host sync), drops past
    ``cap`` to an overflow row -> (disp (E, cap, d), slot, contribution
    weight, sorted_tok, (T*k,) each)."""
    t, d = x_flat.shape
    k = ids.shape[-1]
    flat_ids = ids.reshape(-1)                             # (T*k,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    sorted_tok = order // k
    experts = torch.arange(e, device=x_flat.device, dtype=sorted_ids.dtype)
    starts = torch.searchsorted(sorted_ids, experts)
    pos = torch.arange(t * k, device=x_flat.device) - starts[sorted_ids]
    keep = pos < cap
    slot = torch.where(keep, sorted_ids * cap + pos, e * cap)   # drop -> overflow row
    disp = torch.zeros((e * cap + 1, d), dtype=x_flat.dtype, device=x_flat.device)
    disp.index_copy_(0, slot, x_flat[sorted_tok])
    wgt = weights.reshape(-1)[order] * keep
    return disp[:-1].reshape(e, cap, d), slot, wgt, sorted_tok


def _index_gather_back(out_e: torch.Tensor, slot, wgt, sorted_tok, t: int) -> torch.Tensor:
    """The weighted scatter-back of the expert outputs (E, cap, d) -> (T, d)."""
    e, cap, d = out_e.shape
    flat_out = torch.cat([out_e.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=out_e.dtype, device=out_e.device)])
    out = torch.zeros((t, d), dtype=out_e.dtype, device=out_e.device)
    return out.index_add_(0, sorted_tok, flat_out[slot] * wgt[:, None])


def _experts_index(params, x_flat: torch.Tensor, weights, ids,
                   cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Index dispatch: sort routed token indices by expert (stable),
    capacity-slice, one batched product per expert weight, weighted
    scatter-back.  The sort is global: on a mesh every rank builds the
    whole block from replicated tokens."""
    t, d = x_flat.shape
    k, e = cfg.experts_per_token, cfg.n_experts
    cap = int(t * k / e * cfg.capacity_factor) + 1
    why = "the index dispatch sorts every token of the batch jointly"
    x_flat = shd.reshard(x_flat, (None, None), ctx, why)
    weights = shd.reshard(weights, (None, None), ctx, why)
    ids = shd.reshard(ids, (None, None), ctx, why)
    rep2, rep1 = shd.placements((None, None), ctx), shd.placements((None,), ctx)
    rep3 = shd.placements((None, None, None), ctx)
    disp, slot, wgt, sorted_tok = shd.local(
        lambda xf, w, i: _index_build(xf, w, i, e, cap), ctx, (rep2, rep2, rep2),
        (rep3, rep1, rep1, rep1))(x_flat, weights, ids)
    disp = constrain(disp, ("tp", None, None), ctx)

    h = F.silu(torch.bmm(disp, params["w_gate"])) * torch.bmm(disp, params["w_up"])
    out_e = torch.bmm(h, params["w_down"])                 # (E, cap, d)
    out_e = constrain(out_e, ("tp", None, None), ctx)
    out_e = shd.reshard(out_e, (None, None, None), ctx,
                        "the scatter-back reads every expert's rows by slot")
    return shd.local(lambda oe, sl, wg, st: _index_gather_back(oe, sl, wg, st, t), ctx,
                     (rep3, rep1, rep1, rep1), (rep2,))(out_e, slot, wgt, sorted_tok)


def _local_build(xs: torch.Tensor, ws: torch.Tensor, is_: torch.Tensor,
                 e: int, cap: int) -> tuple:
    """Per-shard dispatch blocks over the leading n_dp axis: xs (n, T_loc,
    d), ws/is_ (n, T_loc, k) -> (disp (n, E, cap, d), slot, wgt, sorted_tok
    (n, T_loc*k) each).  A shard's routed tokens sorted by expert
    (stable), each token's place in its expert's queue, drops past ``cap``
    to an overflow row."""
    n, t_loc, d = xs.shape
    k = is_.shape[-1]
    flat_ids = is_.reshape(n, -1)
    order = torch.argsort(flat_ids, dim=1, stable=True)
    sorted_ids = torch.gather(flat_ids, 1, order)
    sorted_tok = order // k
    experts = torch.arange(e, device=xs.device, dtype=sorted_ids.dtype)
    starts = torch.searchsorted(sorted_ids, experts.expand(n, e).contiguous())
    pos = (torch.arange(t_loc * k, device=xs.device)
           - torch.gather(starts, 1, sorted_ids))
    keep = pos < cap
    slot = torch.where(keep, sorted_ids * cap + pos, e * cap)
    disp = torch.zeros((n, e * cap + 1, d), dtype=xs.dtype, device=xs.device)
    disp.scatter_(1, slot[..., None].expand(-1, -1, d),
                  torch.gather(xs, 1, sorted_tok[..., None].expand(-1, -1, d)))
    wgt = torch.gather(ws.reshape(n, -1), 1, order) * keep
    return disp[:, :-1].reshape(n, e, cap, d), slot, wgt, sorted_tok


def _local_gather_back(out_e: torch.Tensor, slot: torch.Tensor,
                       wgt: torch.Tensor, sorted_tok: torch.Tensor,
                       t_loc: int) -> torch.Tensor:
    """Per-shard weighted scatter-back over the leading n_dp axis: out_e
    (n, E, cap, d) -> (n, T_loc, d)."""
    n, e, cap, d = out_e.shape
    flat = torch.cat([out_e.reshape(n, e * cap, d),
                      torch.zeros((n, 1, d), dtype=out_e.dtype, device=out_e.device)], 1)
    contrib = torch.gather(flat, 1, slot[..., None].expand(-1, -1, d)) * wgt[..., None]
    out = torch.zeros((n, t_loc, d), dtype=out_e.dtype, device=out_e.device)
    return out.scatter_add_(1, sorted_tok[..., None].expand(-1, -1, d), contrib)


def _dp_shards(t: int, ctx) -> int:
    """n_dp: the product of the batch axes' sizes (1 without a mesh, or
    where it does not divide the T tokens), as the reference computes it."""
    n_dp = 1
    if shd.on_mesh(ctx):
        sizes = ctx.axis_sizes
        n_dp = math.prod(sizes[a] for a in ctx.rules.get("batch", ())) or 1
    return 1 if t % n_dp else n_dp


def _experts_local_index(params, x_flat: torch.Tensor, weights, ids,
                         cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Index dispatch per data-parallel shard, with the shard's capacity
    (the reference's ``_experts_local_index``).  The reference reshapes
    the tokens to (n_dp, T_loc, d) with the leading axis on "batch"; here
    the (T, d) tokens on ("batch", None) are the same placement, and each
    rank's build and scatter-back see its (1, T_loc, d) block."""
    t, d = x_flat.shape
    n_dp = _dp_shards(t, ctx)
    t_loc = t // n_dp
    k, e = cfg.experts_per_token, cfg.n_experts
    cap = int(t_loc * k / e * cfg.capacity_factor) + 1
    lead = "batch" if n_dp > 1 else None          # one shard: every rank builds it
    xs = constrain(x_flat, (lead, None), ctx)
    why = "the routed weights and ids follow their tokens' shard"
    ws = shd.reshard(weights, (lead, None), ctx, why)
    is_ = shd.reshard(ids, (lead, None), ctx, why)
    rows2, rows1 = shd.placements((lead, None), ctx), shd.placements((lead, None), ctx)
    block = shd.placements((lead, None, None, None), ctx)
    disp, slot, wgt, sorted_tok = shd.local(
        lambda x_, w_, i_: _local_build(x_.reshape(-1, t_loc, d), w_.reshape(-1, t_loc, k),
                                        i_.reshape(-1, t_loc, k), e, cap), ctx,
        (rows2, rows2, rows2), (block, rows1, rows1, rows1))(xs, ws, is_)
    # the dispatch block's all-to-all: data-parallel shards -> expert shards
    disp = constrain(disp, (lead, "tp", None, None), ctx)
    h = F.silu(torch.einsum("secd,edf->secf", disp, params["w_gate"]))
    h = h * torch.einsum("secd,edf->secf", disp, params["w_up"])
    out_e = torch.einsum("secf,efd->secd", h, params["w_down"])
    out_e = constrain(out_e, (lead, "tp", None, None), ctx)
    out_e = shd.reshard(out_e, (lead, None, None, None), ctx,
                        "the reverse all-to-all: each shard's expert outputs come home")
    out = shd.local(
        lambda o_, s_, w_, t_: _local_gather_back(o_, s_, w_, t_, t_loc).reshape(-1, d), ctx,
        (block, rows1, rows1, rows1), (rows2,))(out_e, slot, wgt, sorted_tok)
    return constrain(out, (lead, None), ctx)


def moe_layer(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> (out, aux_loss).  ``ctx``: a ``runtime/sharding``
    ``ShardCtx`` (None: one card)."""
    b, l, d = x.shape
    x_flat = _tokens(x, ctx)
    weights, ids, aux = _route(params, x_flat, cfg)
    if cfg.moe_dispatch == "dense":
        out = _experts_dense(params, x_flat, weights, ids, cfg)
    elif cfg.moe_dispatch == "index":
        out = _experts_index(params, x_flat, weights, ids, cfg, ctx)
    elif cfg.moe_dispatch == "local_index":
        out = _experts_local_index(params, x_flat, weights, ids, cfg, ctx)
    else:
        raise ValueError(cfg.moe_dispatch)
    if "shared" in params:
        out = out + mlp(params["shared"], x_flat, ctx)
    return _untokens(out, b, l, ctx), aux


def _tokens(x: torch.Tensor, ctx) -> torch.Tensor:
    """(B, L, d) -> (T, d) rows.  On a mesh each rank flattens its own
    rows of the batch (its (B_loc, L, d) block is its T_loc rows): a
    DTensor view would re-derive, in the backward, the placement of a dim
    that two mesh dims split, and gets it wrong."""
    b, l, d = x.shape
    if not shd.on_mesh(ctx):
        return x.reshape(b * l, d)
    x = shd.reshard(x, ("batch", None, None), ctx,
                    "the token rows are the batch's (a no-op on the residual stream)")
    rows = tuple(x.placements)
    return shd.local(lambda t: t.reshape(-1, d), ctx, (rows,), (rows,))(x)


def _untokens(out: torch.Tensor, b: int, l: int, ctx) -> torch.Tensor:
    """``_tokens``' inverse: (T, d) rows -> (B, L, d)."""
    d = out.shape[-1]
    if not shd.on_mesh(ctx):
        return out.reshape(b, l, d)
    rows = shd.placements(("batch", None, None), ctx, (b, l, d))
    lead = "batch" if Shard(0) in rows else None
    out = shd.reshard(out, (lead, None), ctx,
                      "the token rows go back to the batch's (a no-op on every dispatch)")
    return shd.local(lambda t: t.reshape(-1, l, d), ctx, (rows,), (rows,))(out)
