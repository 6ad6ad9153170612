"""internvl2-2b [arXiv:2404.16821; hf] — InternLM2-backbone VLM; the
InternViT frontend is a stub (input_specs feeds precomputed patch
embeddings, 256 media tokens)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab=92553, head_dim=128, frontend="vit_stub", num_media_tokens=256,
)
