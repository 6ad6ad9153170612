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
layer at a time.  The train path (``loss_fn``: ``backbone_train``, then
``chunked_xent``) walks it the same way, each layer under
``torch.utils.checkpoint`` when ``cfg.remat`` is set, as the reference
remats each step of its layer scan; autograd derives the backward.
``LanguageModel`` owns the weights as ``nn.Parameter``s under the spec's
key paths ("layers.attn.wq"), in the reference's layouts, so a reference
parameter tree carries across without transposes
(``convert.lm_params_from_reference``).

On a mesh every function takes the reference's ``ShardCtx`` (``ctx``,
``runtime/sharding.py``; None on one card): the weights are DTensors placed
by ``tree_shardings(model_spec(cfg), ctx)`` (``LanguageModel.init(...,
ctx=)``), the reference's eight ``constrain`` sites of this file place the
activations on ("batch", None, None) and the logits on ("batch", None,
"tp"), and the entry points run inside ``shd.replicated(ctx)`` so that
plain helpers (positions, masks) meet the DTensors as replicated values.
The cross entropy over a tp-sharded vocabulary runs on each rank's logits
(``_xent_rows``): the max and the sum of exponentials and the gold logit
are reduced over the ``tp`` ranks.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (embed, embed_spec, mlp, mlp_spec, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.params import (ParamSpec, check_tree, flatten, initialize,
                                       stack_layers, tree_map)
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import constrain

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec", "audio")
XENT_CHUNK = 512


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

def embed_inputs(params: dict, batch: dict, cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Tokens (+ optional stubbed media embeddings) -> (B, L, d)."""
    x = embed(params["embed"], batch["tokens"], ctx)
    if cfg.family == "vlm" and "media" in batch:
        x = torch.cat([batch["media"].to(x.dtype), x], dim=1)
    return constrain(x, ("batch", None, None), ctx)


def encoder_forward(params: dict, frames: torch.Tensor, cfg: ArchConfig,
                    ctx=None) -> torch.Tensor:
    """Bidirectional encoder over (stub) frame embeddings (B, Le, d), then
    ``enc_norm``."""
    def enc_layer(lp, h):
        h = h + attn.attention_train(lp["attn"], rmsnorm(h, lp["ln1"], cfg.norm_eps),
                                     cfg, ctx, causal=False)
        h = h + mlp(lp["mlp"], rmsnorm(h, lp["ln2"], cfg.norm_eps), ctx)
        return constrain(h, ("batch", None, None), ctx)

    h = _scan_stack(enc_layer, params["enc_layers"], frames, cfg, with_aux=False, ctx=ctx)
    return rmsnorm(h, params["enc_norm"], cfg.norm_eps)


# ===========================================================================
# the train path: layer applications (one layer, unstacked params)
# ===========================================================================

def _apply_dense_layer(lp, x, cfg, ctx):
    x = x + attn.attention_train(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, ctx)
    x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), ctx)
    return constrain(x, ("batch", None, None), ctx)


def _apply_moe_layer(lp, x, cfg, ctx):
    x = x + attn.attention_train(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, ctx)
    out, aux = moe_mod.moe_layer(lp["moe"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg, ctx)
    return constrain(x + out, ("batch", None, None), ctx), aux


def _apply_mamba_layer(lp, x, cfg, ctx):
    x = x + mb.mamba_train(lp["mamba"], rmsnorm(x, lp["ln"], cfg.norm_eps), cfg, ctx)
    return constrain(x, ("batch", None, None), ctx)


def _scalar_zero(ctx, device) -> torch.Tensor:
    """A float32 zero to sum scalars into: replicated on a mesh."""
    return shd.zeros((), (), ctx, dtype=torch.float32, device=device)


def _apply_hybrid_block(bp, x, cfg, ctx):
    """One period block, unrolled: sublayer 0 attention, the rest mamba;
    the FFN an MLP on even sublayers, MoE on odd ones (aux summed)."""
    aux_total = _scalar_zero(ctx, x.device)
    mlp_i = moe_i = 0
    for j in range(cfg.attn_period):
        if j == 0:
            sub = bp["attn"]
            x = x + attn.attention_train(sub["attn"], rmsnorm(x, sub["ln"], cfg.norm_eps),
                                         cfg, ctx)
        else:
            sub = tree_map(lambda a, j=j: a[j - 1], bp["mamba"])
            x = x + mb.mamba_train(sub["mamba"], rmsnorm(x, sub["ln"], cfg.norm_eps), cfg, ctx)
        if j % 2 == 1:
            sub = tree_map(lambda a, i=moe_i: a[i], bp["moe"])
            out, aux = moe_mod.moe_layer(sub["moe"], rmsnorm(x, sub["ln"], cfg.norm_eps),
                                         cfg, ctx)
            x = x + out
            aux_total = aux_total + aux
            moe_i += 1
        else:
            sub = tree_map(lambda a, i=mlp_i: a[i], bp["mlp"])
            x = x + mlp(sub["mlp"], rmsnorm(x, sub["ln"], cfg.norm_eps), ctx)
            mlp_i += 1
        x = constrain(x, ("batch", None, None), ctx)
    return x, aux_total


def _apply_dec_layer(lp, x, enc_out, cfg, ctx):
    x = x + attn.attention_train(lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg, ctx)
    x = x + attn.attention_cross(lp["cross"], rmsnorm(x, lp["ln_x"], cfg.norm_eps),
                                 enc_out, cfg, ctx)
    x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), ctx)
    return constrain(x, ("batch", None, None), ctx)


def _scan_stack(layer_fn, stacked: dict, x: torch.Tensor, cfg: ArchConfig, *,
                with_aux: bool, ctx=None):
    """``layer_fn(lp, x)`` -> x or (x, aux) over the stacked leaves' first
    axis, aux summed in float32.  With ``cfg.remat`` (and a gradient being
    recorded) each layer keeps only its input for the backward and runs
    again there, as the reference's ``jax.checkpoint`` of its scan step.
    ``a[i]`` selects along the layer axis, which no rule shards: on a mesh
    each rank takes its own shards of layer i."""
    n = next(iter(flatten(stacked).values())).shape[0]
    aux = _scalar_zero(ctx, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(n):
        lp = tree_map(lambda a, i=i: a[i], stacked)
        if remat:
            out = checkpoint(layer_fn, lp, x, use_reentrant=False, preserve_rng_state=False)
        else:
            out = layer_fn(lp, x)
        if with_aux:
            x, a = out
            aux = aux + a
        else:
            x = out
    return (x, aux) if with_aux else x


def backbone_train(params: dict, x: torch.Tensor, cfg: ArchConfig,
                   enc_out: torch.Tensor | None = None, ctx=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, d) embedded inputs -> (final-normed hidden (B, L, d), the
    MoE load-balance loss summed over layers, float32)."""
    check_family(cfg)
    fam = cfg.family
    aux = _scalar_zero(ctx, x.device)

    def run(layer_fn, stacked, h, with_aux):
        return _scan_stack(layer_fn, stacked, h, cfg, with_aux=with_aux, ctx=ctx)

    def dense(lp, h):
        return _apply_dense_layer(lp, h, cfg, ctx)

    if fam in ("dense", "vlm"):
        x = run(dense, params["layers"], x, False)
    elif fam == "moe":
        if cfg.first_k_dense:
            x = run(dense, params["dense_layers"], x, False)
        x, aux = run(lambda lp, h: _apply_moe_layer(lp, h, cfg, ctx), params["layers"], x,
                     True)
    elif fam == "ssm":
        x = run(lambda lp, h: _apply_mamba_layer(lp, h, cfg, ctx), params["layers"], x, False)
    elif fam == "hybrid":
        x, aux = run(lambda bp, h: _apply_hybrid_block(bp, h, cfg, ctx), params["blocks"], x,
                     True)
    else:                                   # encdec, audio
        if enc_out is None:
            raise ValueError(f"{cfg.name}: the decoder needs the encoder's output")
        x = run(lambda lp, h: _apply_dec_layer(lp, h, enc_out, cfg, ctx), params["layers"],
                x, False)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux


# ===========================================================================
# losses
# ===========================================================================

def _xent_sum(table: torch.Tensor, hc: torch.Tensor, lc: torch.Tensor,
              tied: bool, ctx=None) -> torch.Tensor:
    """Summed cross entropy of one chunk: float32 logits, logsumexp less
    the gold logit."""
    logits = unembed(table, hc, tied=tied).float()
    if not shd.on_mesh(ctx):
        gold = logits.gather(-1, lc[..., None].long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()
    logits = constrain(logits, ("batch", None, "tp"), ctx)
    return _xent_rows(logits, lc, ctx).sum()


def _xent_rows(logits: torch.Tensor, labels: torch.Tensor, ctx) -> torch.Tensor:
    """Per-position cross entropy (B, C) of logits placed on ("batch",
    None, "tp"), on each rank's vocabulary block: the block's max, sum of
    exponentials and gold logit reduced over the ranks that share the
    positions (the vocabulary's ``tp`` axes).  The max is a constant of the
    gradient, as in ``logsumexp``."""
    lp = tuple(logits.placements)
    rows = shd.placements(("batch", None), ctx, tuple(labels.shape))
    labels = shd.reshard(labels, ("batch", None), ctx,
                         "the labels meet their logits' rows (as placed by batch_shardings)")
    block, v_axes = shd.shard_block(lp, 2, ctx)
    groups = [ctx.mesh.get_group(a) for a in v_axes]

    def rows_xent(lg, lb):
        v_loc = lg.shape[-1]
        m = lg.detach().amax(dim=-1)
        for grp in groups:
            m = shd.max_over(m, grp)
        s = torch.exp(lg - m[..., None]).sum(dim=-1)
        local = lb.long() - block * v_loc
        inside = (local >= 0) & (local < v_loc)
        gold = torch.where(inside, lg.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0],
                           0.0)
        for grp in groups:
            s = shd.sum_over(s, grp)
            gold = shd.sum_over(gold, grp)
        return m + torch.log(s) - gold

    return shd.local(rows_xent, ctx, (lp, rows), (rows,))(logits, labels)


def chunked_xent(params: dict, hidden: torch.Tensor, labels: torch.Tensor,
                 cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Causal-LM cross entropy, the mean over every (batch, position),
    without materialising (B, L, V) logits: chunks of ``XENT_CHUNK``
    positions, each chunk's float32 logits recomputed in the backward.

    The last chunk is shorter when L is not a multiple of the chunk.  The
    reference takes ``L // chunk`` whole chunks and drops the tail's labels
    (``src/repro/models/model.py:243-247``): both agree where L <= 512 or
    L % 512 == 0 (ROADMAP queue 3)."""
    b, l, _ = hidden.shape
    chunk = min(XENT_CHUNK, l)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    total = _scalar_zero(ctx, hidden.device)
    for start in range(0, l, chunk):
        hc, lc = hidden[:, start:start + chunk], labels[:, start:start + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_xent_sum, table, hc, lc, cfg.tie_embeddings, ctx,
                                       use_reentrant=False, preserve_rng_state=False)
        else:
            total = total + _xent_sum(table, hc, lc, cfg.tie_embeddings, ctx)
    return total / (b * l)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig, ctx=None
            ) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B, L), labels (B, L) [, media (B, M, d) | frames
    (B, Le, d)] -> (xent + 0.01 * aux, {"xent", "aux"}).  A VLM's loss
    counts its text positions only; an encoder-decoder runs its encoder
    over the frames (cast to ``cfg.dtype``) first.  On a mesh the loss
    and the metrics are replicated scalars; run it (and its backward)
    inside ``shd.replicated(ctx)``."""
    enc_out = None
    if cfg.family in ("encdec", "audio"):
        enc_out = encoder_forward(params, batch["frames"].to(getattr(torch, cfg.dtype)), cfg,
                                  ctx)
    x = embed_inputs(params, batch, cfg, ctx)
    hidden, aux = backbone_train(params, x, cfg, enc_out=enc_out, ctx=ctx)
    if cfg.family == "vlm" and "media" in batch:
        hidden = hidden[:, batch["media"].shape[1]:]    # loss on text positions
    xent = chunked_xent(params, hidden, batch["labels"], cfg, ctx)
    xent = shd.reshard(xent, (), ctx, "the loss is read on every rank")
    aux = shd.reshard(aux, (), ctx, "the loss is read on every rank")
    return xent + 0.01 * aux, {"xent": xent, "aux": aux}


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
    """An LM of the zoo: the weights of ``model_spec(cfg)`` as parameters
    under the spec's key paths, ``prefill``/``decode_step`` over them
    (``models/serve.py``) and the training ``loss``.  ``ctx`` (a
    ``ShardCtx`` on a mesh, None on one card): where the weights live and
    what the methods pass on."""

    def __init__(self, cfg: ArchConfig, params: dict, ctx=None):
        super().__init__()
        check_tree(model_spec(cfg), params)
        self.cfg = cfg
        self.ctx = ctx
        _register(self, params)

    @classmethod
    def init(cls, generator: torch.Generator, cfg: ArchConfig,
             dtype: torch.dtype | None = None, device=None, ctx=None) -> "LanguageModel":
        """Random weights drawn from ``generator`` (``params.initialize``),
        of ``dtype`` (default: ``cfg.dtype``) on ``device`` (default: the
        card; raises without one unless ``device="cpu"``).  With a mesh
        ``ctx`` each rank draws the whole tree from the same seed and
        keeps its shards (``place``)."""
        dev = resolve_device(device)
        dtype = dtype or getattr(torch, cfg.dtype)
        return cls(cfg, initialize(generator, model_spec(cfg), dtype, dev)).place(ctx)

    def place(self, ctx) -> "LanguageModel":
        """This model's weights placed by ``tree_shardings(model_spec(cfg),
        ctx)`` (each rank keeps its part of its full copy: no broadcast) ->
        a model on that mesh; ``self`` when ``ctx`` has no mesh."""
        if not shd.on_mesh(ctx):
            return self
        placed = tree_map(shd.place, self.params(),
                          shd.tree_shardings(model_spec(self.cfg), ctx))
        return LanguageModel(self.cfg, tree_map(lambda p: p.detach(), placed), ctx)

    def params(self) -> dict:
        """The weights as the nested dict the serving functions take."""
        return _tree(self)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def prefill(self, batch: dict, cache_seq: int):
        from repro_torch.models import serve

        return serve.prefill(self.params(), batch, self.cfg, cache_seq, self.ctx)

    def decode_step(self, tokens: torch.Tensor, caches: dict, pos: int):
        from repro_torch.models import serve

        return serve.decode_step(self.params(), tokens, caches, pos, self.cfg, self.ctx)

    def loss(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """``loss_fn`` over the weights: (loss, {"xent", "aux"}).  The batch
        must lie on the weights' device: nothing is moved.  The weights
        record no gradient (``requires_grad`` is off); ``runtime/steps.py``
        ``make_train_step`` trains them."""
        for k, v in batch.items():
            if v.device != self.device:
                raise ValueError(f"batch[{k!r}] lies on {v.device}, the weights on "
                                 f"{self.device}")
        with shd.replicated(self.ctx):
            return loss_fn(self.params(), batch, self.cfg, self.ctx)
