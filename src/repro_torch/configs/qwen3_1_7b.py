"""qwen3-1.7b [hf:Qwen/Qwen3-8B; hf] — qk_norm, GQA kv=8, tied embeddings."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, tie_embeddings=True,
)
