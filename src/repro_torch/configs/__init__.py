"""Architecture registry: exact assigned configs + reduced smoke variants.

Every assigned architecture is selectable via ``--arch <id>``; SHAPES defines
the assigned input-shape cells.  ``smoke_config(id)`` returns a same-family
reduced config for CPU tests.  Shapes only: nothing here downloads a
weight or a ``config.json``; a full config runs on the card with random
weights (``python -m repro_torch.launch.serve --arch qwen3_1_7b``).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCHS = [
    "qwen3_1_7b",
    "qwen3_14b",
    "stablelm_12b",
    "phi3_medium_14b",
    "mamba2_130m",
    "recurrentgemma_9b",
    "whisper_medium",
    "deepseek_v2_lite_16b",
    "mixtral_8x22b",
    "llama_3_2_vision_90b",
]

# Assigned input shape cells: name -> (seq_len, global_batch, mode)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention (DESIGN.md §5): decode against a
# full-attention 500k cache is linear per step but the *cache itself* and the
# paper-spec rule exclude pure full-attention archs.
LONG_CONTEXT_ARCHS = {"mamba2_130m", "recurrentgemma_9b", "mixtral_8x22b"}


def config_for(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE


def cells(arch: str):
    """Assigned (shape_name, seq, batch, mode) cells for one architecture."""
    out = []
    for name, (seq, batch, mode) in SHAPES.items():
        if name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            continue
        out.append((name, seq, batch, mode))
    return out


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving reduction used by every <arch>.py SMOKE config."""
    base = dict(
        n_layers=max(2, len(cfg.block_pattern) or 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        d_head=16,
        d_ff=128,
        vocab=256,
        window=min(cfg.window, 8) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_d_ff=32 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        rope_head_dim=8 if cfg.kv_lora_rank else 64,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8 if cfg.ssm_state else 64,
        ssm_chunk=4 if cfg.ssm_state else 128,
        lru_width=0,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0,
        cross_attn_every=cfg.cross_attn_every,
        flash_threshold=16,
        attn_chunk_q=8,
        attn_chunk_k=8,
        dtype="float32",
        name=cfg.name + "-smoke",
    )
    if cfg.cross_attn_every:
        base["n_layers"] = cfg.cross_attn_every  # one superblock
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
