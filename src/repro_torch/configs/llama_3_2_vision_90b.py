"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision;
unverified].

Every 5th layer is a gated cross-attention layer over stub vision tokens
(precomputed patch embeddings: 1601 patches x 2 tiles = 3202 tokens).
100 layers = 20 scanned superblocks of (cross, self x4).
"""
from repro_torch.configs import reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab=128256,
    rope_theta=5e5,
    cross_attn_every=5,
    n_vision_tokens=3202,
)

SMOKE = reduce_for_smoke(CONFIG, cross_attn_every=2, n_layers=2)
