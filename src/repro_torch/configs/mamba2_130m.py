"""mamba2-130m [ssm]: 24L d_model=768 (attn-free) vocab=50280, ssm_state=128
— SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.configs import reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,        # attention-free; SSD heads derive from d_inner/head_dim
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    tie_embeddings=True,
)

SMOKE = reduce_for_smoke(CONFIG)
