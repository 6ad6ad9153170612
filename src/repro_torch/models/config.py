"""Unified architecture configuration for the LM zoo (the port's copy of
the reference's ``models/config.py``: plain arithmetic, no tensors).

One dataclass covers all six families (dense / moe / ssm / hybrid / encdec /
vlm / audio); family-specific fields are zero/None when unused.  Exact
figures for each architecture live in ``repro_torch/configs/<id>.py``.
The port serves every family.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                 # 0 => attention-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    qk_norm: bool = False
    attn_bias: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0            # per-expert hidden dim (fine-grained MoE)
    moe_period: int = 1          # MoE every `moe_period` layers
    first_k_dense: int = 0       # leading dense layers (deepseek-moe: 1)
    moe_dispatch: str = "index"  # "index" (optimized) | "dense" (naive baseline)
    capacity_factor: float = 1.25

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0         # 0 => ceil(d_model / 16)
    ssm_chunk: int = 256         # time tile of the chunked selective scan
    ssm_checkpoint_chunks: bool = False  # remat each chunk (§Perf: bounds the
                                         # assoc-scan bwd tree working set)

    # --- hybrid (jamba): one attention layer per `attn_period` layers ---
    attn_period: int = 0

    # --- encoder-decoder ---
    enc_layers: int = 0          # >0 => encdec; n_layers = decoder layers
    cross_attention: bool = False

    # --- modality frontend stubs ---
    frontend: str | None = None  # "vit_stub" | "audio_stub"
    num_media_tokens: int = 256

    # --- common ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # §Perf knob: keep chunked-attention probabilities/accumulator in bf16
    # (fp32 running max/sum retained) — halves the dominant HBM term of
    # long-context prefill at <1e-2 relative error (see EXPERIMENTS §Perf)
    attn_bf16_intermediates: bool = False
    attn_kv_chunk: int = 512     # KV tile of chunked attention (§Perf: larger
                                 # tiles amortize accumulator read/write rounds)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can run 500k-token decode (ssm / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, self.attn_period or 2) if self.family == "hybrid" else 2,
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            head_dim=16 if self.n_heads else 0,
            n_experts=min(self.n_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 8),
            enc_layers=2 if self.enc_layers else 0,
            num_media_tokens=8 if self.frontend else 0,
            dtype="float32",
            remat=False,
            # avoid MoE capacity drops at smoke-test batch sizes (drops are a
            # batch-composition effect, not what smoke tests should assert on)
            capacity_factor=8.0,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def param_count(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter estimates (embedding included)."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.resolved_head_dim
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d

    def mlp(f):
        return 3 * d * f  # gated SwiGLU

    mamba = (d * 2 * cfg.d_inner + cfg.d_inner * cfg.ssm_conv
             + cfg.d_inner * (cfg.dt_rank + 2 * cfg.ssm_state)
             + cfg.dt_rank * cfg.d_inner + cfg.d_inner * cfg.ssm_state
             + cfg.d_inner * d) if cfg.ssm_state else 0

    total = active = 0
    n_attn_layers = 0
    for layer in range(cfg.n_layers):
        is_attn = (cfg.family != "ssm") and (
            cfg.attn_period == 0 or layer % cfg.attn_period == 0)
        mixer = attn if is_attn else mamba
        if cfg.family == "ssm":
            mixer = mamba
        n_attn_layers += is_attn
        is_moe = (cfg.is_moe and layer >= cfg.first_k_dense
                  and (layer % cfg.moe_period == cfg.moe_period - 1 or cfg.moe_period == 1))
        if is_moe:
            eff = cfg.moe_d_ff or ff
            tot_ffn = (cfg.n_experts * mlp(eff)
                       + cfg.n_shared_experts * mlp(eff) + d * cfg.n_experts)
            act_ffn = (cfg.experts_per_token * mlp(eff)
                       + cfg.n_shared_experts * mlp(eff) + d * cfg.n_experts)
        elif ff:
            tot_ffn = act_ffn = mlp(ff)
        else:
            tot_ffn = act_ffn = 0
        total += mixer + tot_ffn
        active += mixer + act_ffn
    enc = cfg.enc_layers * (attn + mlp(ff)) if cfg.enc_layers else 0
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    return total + enc + emb, active + enc + emb
