"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA [arXiv:2401.04088; hf].

Sliding-window attention (window 4096) makes the decode cache O(window),
which is why this arch runs the long_500k cell.
"""
from repro_torch.configs import reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=32768,
    attn_kind="sliding",
    window=4096,
    n_experts=8,
    top_k=2,
    moe_d_ff=16384,
)

SMOKE = reduce_for_smoke(CONFIG)
