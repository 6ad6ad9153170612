"""llama3.2-3b [hf:meta-llama/Llama-3.2-1B; unverified] — small llama3."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=128256, head_dim=128, tie_embeddings=True, rope_theta=5e5,
)
