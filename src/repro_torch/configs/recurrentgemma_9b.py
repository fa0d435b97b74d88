"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn, 1:2 [arXiv:2402.19427; unverified].

Pattern: (rglru, rglru, local-attn) repeating; 38 = 12x3 + 2, so the stack is
12 scanned superblocks + a 2-layer (rglru, rglru) tail.  Local attention
window 2048, MQA (kv=1).
"""
from repro_torch.configs import reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab=256000,
    window=2048,
    block_pattern=("rglru", "rglru", "attn_local"),
    lru_width=4096,
    tie_embeddings=True,
)

SMOKE = reduce_for_smoke(CONFIG, n_layers=4, window=8)  # 1 superblock + 1 tail
