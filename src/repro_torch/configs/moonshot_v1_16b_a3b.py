"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B; hf] — kimi/moonlight,
deepseek-family fine-grained MoE, 64 routed top-6 (+2 shared)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=163840, head_dim=128,
    n_experts=64, experts_per_token=6, n_shared_experts=2, moe_d_ff=1408,
    first_k_dense=1,
)
