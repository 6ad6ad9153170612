"""Mamba-1 selective SSM layer (falcon-mamba-7b, jamba's mamba sublayers):
the serving half of the reference's ``models/mamba.py``.

Structure (Gu & Dao 2023): in_proj -> (x, z); causal depthwise conv (k=4);
SiLU; data-dependent (dt, B, C); a selective state-space scan over time
with diagonal A; gate by SiLU(z); out_proj.

Prefill splits time into ``SSM_CHUNK`` blocks, as the reference does.
Inside a block the linear recurrence h_t = da_t * h_{t-1} + dbx_t is a
log-depth doubling scan (``_chunk_scan``): step j combines index t with
t - 2^j by the reference's combinator, so the (B, Q, di, st) expansion
lives one block at a time; across blocks the (B, di, st) state is carried,
as the reference's outer ``lax.scan`` carries it.  The doubling order
rounds differently from XLA's ``associative_scan``, so the state agrees
with the reference to float32 tolerance, not bit for bit.  A running
product of ``da`` divided out is never formed: at the reference's init it
underflows float32 to 0 within about a hundred steps.

Training (``mamba_train``) runs the same doubling scan out of place
(``_scan_train``: every level a new tensor, so autograd can take it) in
chunks of ``cfg.ssm_chunk`` with the state carried, each chunk under
``torch.utils.checkpoint`` when ``cfg.ssm_checkpoint_chunks`` is set.  Its
arithmetic is prefill's, step for step.

Decode keeps the (B, di, st) float32 state and the last k-1 pre-conv
activations, and advances one token a call.

On a mesh (``ctx``) the reference's two ``constrain`` sites put ``xr`` on
("batch", None, "tp"); the zero state is made placed as the decode cache's
("batch", "tp", None).  The doubling scan touches one (d_inner, state)
channel at a time, so it runs on each rank's shards (``shd.local``) with
no collective.  Splitting ``in_proj``'s tp-sharded 2 * d_inner output
into x and z moves columns between ranks (rank r's block holds x or z,
not both), a redistribution the reference's partitioner makes implicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.sharding import constrain

SSM_CHUNK = 256  # time chunk: bounds the live (B, Q, di, st) state expansion


def mamba_spec(cfg: ArchConfig) -> dict:
    d, di, st, dtr, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                         cfg.dt_rank, cfg.ssm_conv)
    return {
        "in_proj": ParamSpec((d, 2 * di), ("fsdp", "tp")),
        "conv_w": ParamSpec((k, di), (None, "tp")),
        "conv_b": ParamSpec((di,), ("tp",), init="zeros"),
        "x_proj": ParamSpec((di, dtr + 2 * st), ("tp", None)),
        "dt_proj_w": ParamSpec((dtr, di), (None, "tp")),
        "dt_proj_b": ParamSpec((di,), ("tp",), init="ones"),
        "a_log": ParamSpec((di, st), ("tp", None), init="ones"),
        "d_skip": ParamSpec((di,), ("tp",), init="ones"),
        "out_proj": ParamSpec((di, d), ("tp", "fsdp")),
    }


def _ssm_inputs(params, xc: torch.Tensor, cfg: ArchConfig, mask=None, ctx=None):
    """xc: (B, L, di) post-conv activations -> da (B, L, di, st), dbx, c.

    mask: optional (L,) validity; masked steps get dt = 0, so da = 1 and
    dbx = 0 and the recurrence passes the state through unchanged.

    The casts are the reference's: the projections, ``dt`` and ``dt * b``
    stay in the activation dtype; ``a``, ``da`` and ``dbx`` are float32."""
    st, dtr = cfg.ssm_state, cfg.dt_rank
    proj = xc @ params["x_proj"]
    # x_proj contracts the tp-sharded d_inner: a partial sum on a mesh, summed
    # here as the reference's partitioner does (torch 2.11 plans a move from
    # Shard to Partial that it cannot carry out when left to choose)
    proj = shd.reshard(proj, ("batch", None, None), ctx,
                       "x_proj's partial sums over tp reduced before the split")
    dt, b, c = proj.split([dtr, st, st], dim=-1)
    dt = F.softplus(dt @ params["dt_proj_w"] + params["dt_proj_b"])   # (B,L,di)
    if mask is not None:
        dt = dt * mask[None, :, None].to(dt.dtype)
    a = -torch.exp(params["a_log"].float())                           # (di, st)
    da = torch.exp(dt[..., None].float() * a)                         # (B,L,di,st)
    dbx = (dt[..., None] * b[..., None, :]).float() * xc[..., None].float()
    return da, dbx, c.float()


def _conv_train(params, x: torch.Tensor, k: int, ctx=None) -> torch.Tensor:
    """Causal depthwise conv over time: x (B, L, di)."""
    pad = shd.pad(x, (0, 0, k - 1, 0), ctx)
    out = sum(pad[:, i:i + x.shape[1]] * params["conv_w"][i] for i in range(k))
    return out + params["conv_b"]


def _chunk_scan(da: torch.Tensor, dbx: torch.Tensor):
    """Inclusive scan of h_t = da_t * h_{t-1} + dbx_t over axis 1 from
    h = 0 -> (cumulative da, h), by doubling: at step j every index
    t >= 2^j takes (a, b)[t - 2^j] as its left operand under the
    reference's combinator (a_l * a_r, b_l * a_r + b_r).  Two buffers a
    quantity, the inputs among them: they are overwritten."""
    a, b = da, dbx
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    q, s = a.shape[1], 1
    while s < q:
        a2[:, :s], b2[:, :s] = a[:, :s], b[:, :s]
        torch.mul(a[:, :-s], a[:, s:], out=a2[:, s:])
        torch.addcmul(b[:, s:], b[:, :-s], a[:, s:], out=b2[:, s:])
        a, a2, b, b2 = a2, a, b2, b
        s *= 2
    return a, b


def _scan_train(da: torch.Tensor, dbx: torch.Tensor):
    """``_chunk_scan``'s doubling steps out of place: each level is a new
    tensor (autograd refuses ``out=`` on tensors that need a gradient), the
    same products and sums in the same order."""
    a, b = da, dbx
    q, s = a.shape[1], 1
    while s < q:
        a, b = (torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1),
                torch.cat([b[:, :s], torch.addcmul(b[:, s:], b[:, :-s], a[:, s:])], dim=1))
        s *= 2
    return a, b


def _in_proj(params, x: torch.Tensor, ctx) -> tuple[torch.Tensor, torch.Tensor]:
    """in_proj, split into (xr, z), each (B, L, di)."""
    xi = x @ params["in_proj"]
    xi = shd.reshard(xi, ("batch", None, None), ctx,
                     "splitting in_proj's tp-sharded 2 * d_inner into x and z")
    return xi.chunk(2, dim=-1)


def _on_shards(core, ctx, da, dbx, c, h0):
    """``core(da, dbx, c, h0)`` on each rank's shards, the outputs (the
    carried state (B, di, st), y (B, Q, di)) placed by ("batch", "tp",
    None) and ("batch", None, "tp"); ``core`` itself without a mesh.  A
    selective scan touches one (d_inner, state) channel at a time, so it
    needs no collective."""
    if not shd.on_mesh(ctx):
        return core(da, dbx, c, h0)
    why = "the scan's operands on their batch and d_inner shards (a no-op on every path)"
    expand, rows, state = ("batch", None, "tp", None), ("batch", None, None), ("batch", "tp", None)
    da, dbx = shd.reshard(da, expand, ctx, why), shd.reshard(dbx, expand, ctx, why)
    c, h0 = shd.reshard(c, rows, ctx, why), shd.reshard(h0, state, ctx, why)
    y_pl = shd.placements(("batch", None, "tp"), ctx, tuple(da.shape[:3]))
    ins = (tuple(da.placements), tuple(dbx.placements), tuple(c.placements),
           tuple(h0.placements))
    # c is read by every d_inner shard: its gradient sums over them
    grads = ins[:2] + (shd.partial_where(ins[2], ins[0], 2),) + ins[3:]
    return shd.local(core, ctx, ins, (h0.placements, y_pl), grads)(da, dbx, c, h0)


def _chunk_train(da, dbx, c, h0):
    """One training chunk: the out-of-place scan seeded with the carried
    state -> (the state at the chunk's end, y (B, Q, di))."""
    cum_a, hs = _scan_train(da, dbx)
    hs = cum_a * h0[:, None] + hs                                     # seed carry
    return hs[:, -1], (hs @ c[..., None])[..., 0]


def _chunk_prefill(da, dbx, c, h0):
    """One prefill chunk: ``_chunk_train``'s arithmetic in place (``da``
    and ``dbx`` are overwritten)."""
    cum_a, hs = _chunk_scan(da, dbx)
    del da, dbx                                  # frees the scan's spare buffers
    hs = cum_a.mul_(h0[:, None]).add_(hs)                             # seed carry
    return hs[:, -1].clone(), (hs @ c[..., None])[..., 0]


def _gate_out(params, y: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The skip term in float32, the SiLU(z) gate in ``dtype``, out_proj."""
    y = y + xc.float() * params["d_skip"].float()
    return (y.to(dtype) * F.silu(z)) @ params["out_proj"]


def mamba_train(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """Full-sequence selective scan for training, x (B, L, d) -> (B, L, d).

    Time is split into chunks of ``min(cfg.ssm_chunk or SSM_CHUNK, L)``, the
    last one shorter where L is not a whole number of chunks (a doubling
    scan's value at t reads only t' <= t, so no padding is needed; the
    reference pads and cuts ``y`` to L).  Each chunk's (B, Q, di, st)
    expansion is scanned out of place and seeded with the carried state;
    with ``cfg.ssm_checkpoint_chunks`` a chunk keeps only its inputs for the
    backward and recomputes the expansion there."""
    bsz, l, _ = x.shape
    xr, z = _in_proj(params, x, ctx)                                  # (B,L,di)
    xr = constrain(xr, ("batch", None, "tp"), ctx)
    xc = F.silu(_conv_train(params, xr, cfg.ssm_conv, ctx))

    def chunk_step(xc_chunk, h0):
        da, dbx, c = _ssm_inputs(params, xc_chunk, cfg, ctx=ctx)
        return _on_shards(_chunk_train, ctx, da, dbx, c, h0)          # (B,di,st), (B,Q,di)

    q = min(cfg.ssm_chunk or SSM_CHUNK, l)
    h = shd.zeros((bsz, cfg.d_inner, cfg.ssm_state), ("batch", "tp", None), ctx,
                  dtype=torch.float32, device=x.device)
    ys = []
    for start in range(0, l, q):
        xc_chunk = xc[:, start:start + q]
        if cfg.ssm_checkpoint_chunks:
            h, y = checkpoint(chunk_step, xc_chunk, h, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = chunk_step(xc_chunk, h)
        ys.append(y)
    return _gate_out(params, torch.cat(ys, dim=1), xc, z, x.dtype)


def mamba_prefill(params: dict, x: torch.Tensor, cfg: ArchConfig, ctx=None
                  ) -> tuple[torch.Tensor, dict]:
    """Full-sequence scan, x (B, L, d) -> (out (B, L, d), decode state:
    the (B, di, st) SSM state at t = L - 1 and the last k - 1 pre-conv
    activations).  The chunk is ``min(SSM_CHUNK, L)`` whatever
    ``cfg.ssm_chunk`` says, as in the reference's prefill; the padded
    tail's steps get dt = 0.  A prompt shorter than k - 1 has no conv tail
    and raises ``ValueError`` (the reference fails on it too)."""
    bsz, l, _ = x.shape
    k = cfg.ssm_conv
    if l < k - 1:
        raise ValueError(f"a mamba prefill needs at least ssm_conv - 1 = {k - 1} "
                         f"positions for its conv tail, got {l}")
    xr, z = _in_proj(params, x, ctx)                                  # (B,L,di)
    xr = constrain(xr, ("batch", None, "tp"), ctx)
    xc = F.silu(_conv_train(params, xr, k, ctx))

    q = min(SSM_CHUNK, l)
    n_chunks = -(-l // q)
    pad = n_chunks * q - l
    xcp = shd.pad(xc, (0, 0, 0, pad), ctx) if pad else xc
    # padded steps get dt = 0 (state pass-through), so h_last is h at t = l - 1
    valid = (torch.arange(n_chunks * q, device=x.device) < l).float()
    h = shd.zeros((bsz, cfg.d_inner, cfg.ssm_state), ("batch", "tp", None), ctx,
                  dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n_chunks):
        # no name holds da and dbx: the chunk frees them as it goes
        h, y = _on_shards(_chunk_prefill, ctx,
                          *_ssm_inputs(params, xcp[:, i * q:(i + 1) * q], cfg,
                                       mask=valid[i * q:(i + 1) * q], ctx=ctx), h)
        ys.append(y)                                                  # (B,Q,di)
    y = torch.cat(ys, dim=1)[:, :l]
    out = _gate_out(params, y, xc, z, x.dtype)
    return out, {"ssm": h, "conv": xr[:, l - (k - 1):].clone()}


def mamba_init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device=None, lead: tuple[int, ...] = ()) -> dict:
    """Zero decode state on ``device`` (default: the card): the SSM state
    (*lead, B, di, st) in float32 and the conv tail (*lead, B, k-1, di) in
    ``dtype``; ``lead`` stacks it over layers, as the caches do."""
    dev = resolve_device(device)
    return {
        "ssm": torch.zeros((*lead, batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                            device=dev),
    }


def mamba_decode(params: dict, x: torch.Tensor, state: dict, cfg: ArchConfig, ctx=None
                 ) -> tuple[torch.Tensor, dict]:
    """One token step. x: (B, 1, d); state: {"ssm", "conv"} -> (out, the
    new state; the tensors of ``state`` are not written)."""
    xr, z = _in_proj(params, x, ctx)                                  # (B,1,di)
    window = torch.cat([state["conv"], xr], dim=1)                    # (B,k,di)
    xc = torch.einsum("bkd,kd->bd", window, params["conv_w"]) + params["conv_b"]
    xc = F.silu(xc)[:, None]                                          # (B,1,di)
    da, dbx, c = _ssm_inputs(params, xc, cfg)
    h = state["ssm"] * da[:, 0] + dbx[:, 0]                           # (B,di,st)
    y = (h @ c[:, 0, :, None])[..., 0][:, None]                       # (B,1,di)
    out = _gate_out(params, y, xc, z, x.dtype)
    return out, {"ssm": h, "conv": window[:, 1:]}
