"""whisper-medium [audio]: 24L d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=51865 — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

n_layers = 24 per side (whisper-medium is 24 enc + 24 dec).  The conv
frontend is a STUB per the assignment: input_specs provide precomputed frame
embeddings [B, S_enc, d_model].
"""
from repro_torch.configs import reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    tie_embeddings=True,
)

SMOKE = reduce_for_smoke(CONFIG, n_kv_heads=4)
