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
  mesh n_dp = 1, as in the reference; over a mesh the leading axis is the
  one to shard, which the LM-on-a-mesh slice of the port does (until then a
  mesh raises).

Router: softmax over experts, top-k (ties to the lower expert id, as
``jax.lax.top_k``), weights renormalised over the selected experts, and a
Switch-style load-balance loss returned to the caller.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import mlp, mlp_spec
from repro_torch.models.params import ParamSpec


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
                          device=x_flat.device)
    combine.scatter_add_(1, ids, weights)
    h = F.silu(x_flat @ params["w_gate"]) * (x_flat @ params["w_up"])   # (E, T, f)
    outs = h @ params["w_down"]                                          # (E, T, d)
    return torch.einsum("etd,te->td", outs, combine)


def _experts_index(params, x_flat: torch.Tensor, weights, ids,
                   cfg: ArchConfig) -> torch.Tensor:
    """Index dispatch: sort routed token indices by expert (stable),
    capacity-slice, one batched product per expert weight, weighted
    scatter-back."""
    t, d = x_flat.shape
    k, e = cfg.experts_per_token, cfg.n_experts
    cap = int(t * k / e * cfg.capacity_factor) + 1

    flat_ids = ids.reshape(-1)                             # (T*k,)
    flat_w = weights.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    sorted_tok = order // k

    # position of each routed token within its expert's queue: its index
    # in the sorted list less its expert's first index (no host sync)
    experts = torch.arange(e, device=x_flat.device, dtype=sorted_ids.dtype)
    starts = torch.searchsorted(sorted_ids, experts)
    pos = torch.arange(t * k, device=x_flat.device) - starts[sorted_ids]
    keep = pos < cap
    slot = torch.where(keep, sorted_ids * cap + pos, e * cap)   # drop -> overflow row

    xs = x_flat[sorted_tok]                                # (T*k, d) gather
    disp = torch.zeros((e * cap + 1, d), dtype=x_flat.dtype, device=x_flat.device)
    disp.index_copy_(0, slot, xs)
    disp = disp[:-1].reshape(e, cap, d)

    h = F.silu(torch.bmm(disp, params["w_gate"])) * torch.bmm(disp, params["w_up"])
    out_e = torch.bmm(h, params["w_down"])                 # (E, cap, d)

    flat_out = torch.cat([out_e.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=out_e.dtype, device=out_e.device)])
    contrib = flat_out[slot] * (flat_w[order] * keep)[:, None]
    out = torch.zeros((t, d), dtype=x_flat.dtype, device=x_flat.device)
    return out.index_add_(0, sorted_tok, contrib)


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


def _experts_local_index(params, x_flat: torch.Tensor, weights, ids,
                         cfg: ArchConfig, n_dp: int = 1) -> torch.Tensor:
    """Index dispatch per data-parallel shard, with the shard's capacity
    (the reference's ``_experts_local_index``; n_dp = 1 without a mesh)."""
    t, d = x_flat.shape
    if t % n_dp:
        n_dp = 1
    t_loc = t // n_dp
    k, e = cfg.experts_per_token, cfg.n_experts
    cap = int(t_loc * k / e * cfg.capacity_factor) + 1
    disp, slot, wgt, sorted_tok = _local_build(
        x_flat.reshape(n_dp, t_loc, d), weights.reshape(n_dp, t_loc, k),
        ids.reshape(n_dp, t_loc, k), e, cap)
    h = F.silu(torch.einsum("secd,edf->secf", disp, params["w_gate"]))
    h = h * torch.einsum("secd,edf->secf", disp, params["w_up"])
    out_e = torch.einsum("secf,efd->secd", h, params["w_down"])
    return _local_gather_back(out_e, slot, wgt, sorted_tok, t_loc).reshape(t, d)


def moe_layer(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) -> (out, aux_loss).  ``ctx``: a ``runtime/sharding``
    ``ShardCtx`` (None: one card)."""
    b, l, d = x.shape
    x_flat = x.reshape(b * l, d)
    weights, ids, aux = _route(params, x_flat, cfg)
    if cfg.moe_dispatch == "dense":
        out = _experts_dense(params, x_flat, weights, ids, cfg)
    elif cfg.moe_dispatch == "index":
        out = _experts_index(params, x_flat, weights, ids, cfg)
    elif cfg.moe_dispatch == "local_index":
        if ctx is not None and ctx.mesh is not None:
            raise NotImplementedError(
                "moe_dispatch='local_index' over a mesh shards the dispatch's "
                "leading axis; it comes with the next slice of the port, the "
                "LM on a mesh (ROADMAP queue 1)")
        out = _experts_local_index(params, x_flat, weights, ids, cfg)
    else:
        raise ValueError(cfg.moe_dispatch)
    if "shared" in params:
        out = out + mlp(params["shared"], x_flat)
    return out.reshape(b, l, d), aux
