"""Common transformer layers: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Plain PyTorch, one function per function of the reference's
``models/layers.py``, with its order of operations and dtypes: reductions
and rotations in float32, results cast back to the input's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec
from repro_torch.runtime import sharding as shd

# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones")


def mlp_spec(d: int, ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d, ff), ("fsdp", "tp")),
        "w_up": ParamSpec((d, ff), ("fsdp", "tp")),
        "w_down": ParamSpec((ff, d), ("tp", "fsdp")),
    }


def embed_spec(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), ("tp", "fsdp"), init="embed")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast to ``x``'s dtype, then scale."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def mlp(params: dict, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """SwiGLU MLP.  On a mesh (``ctx``) the weights' fsdp shards are
    gathered first, so gate/up keep their tp columns and down its tp rows
    beside the batch's rows, as the reference's partitioner runs them; left
    to itself, DTensor may shard a product's contraction over the data axis
    and gather d_ff instead (cheaper to move at a few hundred tokens), which
    repeats the product on every tp rank."""
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if shd.on_mesh(ctx):
        why = "the MLP's fsdp shards gathered for a tp-sharded product"
        wg = shd.reshard(wg, (None, "tp"), ctx, why)
        wu = shd.reshard(wu, (None, "tp"), ctx, why)
        wd = shd.reshard(wd, ("tp", None), ctx, why)
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, L, H, hd); positions: (L,) or (B, L).  Half-split rotation
    (first half against second half, not interleaved pairs), computed in
    float32 and cast back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., L, hd/2)
    if angles.ndim == 2:                                     # (L, hd/2) -> broadcast B
        angles = angles[None]
    cos = torch.cos(angles)[..., None, :]                    # (B, L, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor, ctx=None) -> torch.Tensor:
    """``table[tokens]``.  On a mesh (``ctx``) the lookup runs on each
    rank's vocabulary block of the table (its d_model shards gathered
    first): a token outside the block reads zeros, and the blocks' rows are
    summed over the vocabulary's ``tp`` ranks, as a vocabulary-parallel
    embedding does."""
    if not shd.on_mesh(ctx):
        return table[tokens]
    table = shd.reshard(table, ("tp", None), ctx,
                        "the embedding gathers its d_model (fsdp) shards for the lookup")
    tokens = shd.reshard(tokens, ("batch", None), ctx,
                         "the tokens on the batch's shards (a no-op for placed inputs)")
    block, v_axes = shd.shard_block(tuple(table.placements), 0, ctx)
    groups = [ctx.mesh.get_group(a) for a in v_axes]

    def look(t, tok):
        local = tok.long() - block * t.shape[0]
        inside = (local >= 0) & (local < t.shape[0])
        out = torch.where(inside[..., None], t[local.clamp(0, t.shape[0] - 1)], 0)
        for grp in groups:
            out = shd.sum_over(out, grp)
        return out

    rows = shd.placements(("batch", None, None), ctx, (*tokens.shape, table.shape[1]))
    tp, kp = tuple(table.placements), tuple(tokens.placements)
    # each batch shard adds its rows' gradients to the (replicated) table
    return shd.local(look, ctx, (tp, kp), (rows,),
                     (shd.partial_where(tp, kp, 0), kp))(table, tokens)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, *, tied: bool) -> torch.Tensor:
    """Logits; tied => table is (V, d), else head is (d, V)."""
    if tied:
        return x @ table_or_head.T
    return x @ table_or_head
