"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained MoE, 2 shared + 64
routed experts top-6, first layer dense."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, head_dim=128,
    n_experts=64, experts_per_token=6, n_shared_experts=2, moe_d_ff=1408,
    first_k_dense=1,
)
