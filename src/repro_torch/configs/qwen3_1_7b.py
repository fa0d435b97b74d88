"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936
— qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs import reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

SMOKE = reduce_for_smoke(CONFIG)
