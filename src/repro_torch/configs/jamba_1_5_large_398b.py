"""jamba-1.5-large-398b [arXiv:2403.19887; hf] — hybrid Mamba+attention 1:7
interleave (1 attention per 8-layer period block), MoE 16e top-2 on every
other layer.  bf16 optimizer state (optim.OptConfig.state_dtype) is the
intended training mode at this size (fp32 state would not fit the assumed
fleet)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab=65536, head_dim=128, attn_period=8,
    n_experts=16, experts_per_token=2, moe_period=2, moe_d_ff=24576,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
)
