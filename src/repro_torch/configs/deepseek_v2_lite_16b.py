"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff=1408 vocab=102400,
MoE 64e top-6 — MLA kv_lora=512, 2 shared [arXiv:2405.04434; hf].

Config note (DESIGN.md §9): the assignment brackets both "MoE 64e top-6" and
"160 routed"; we follow the leading spec — 64 routed + 2 shared experts,
top-6 — which matches the public V2-Lite ("160" belongs to full V2).
First layer uses a dense FFN (d_ff=10944), as in the HF config.
"""
from repro_torch.configs import reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=10944,            # first dense layer
    vocab=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    rope_head_dim=64,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
)

SMOKE = reduce_for_smoke(CONFIG, d_ff=96)
