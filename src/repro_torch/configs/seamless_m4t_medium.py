"""seamless-m4t-medium [arXiv:2308.11596; hf] — encoder-decoder; the audio
frontend is a stub (input_specs feeds precomputed frame embeddings)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, enc_layers=12, cross_attention=True,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    head_dim=64, frontend="audio_stub",
)
