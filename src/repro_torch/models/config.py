"""Unified model configuration for the 10 assigned architectures (a copy of
the JAX package's, plain Python: the port imports nothing of it)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm | hybrid | encdec | moe | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads

    # attention
    attn_kind: str = "full"     # full | sliding | mla
    window: int = 0             # sliding/local attention window
    qk_norm: bool = False
    rope_theta: float = 1e4

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    rope_head_dim: int = 64

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4

    # hybrid (RecurrentGemma / Griffin): layer pattern within a superblock
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "attn")
    lru_width: int = 0                     # 0 -> d_model

    # enc-dec (whisper): n_layers applies to each side
    enc_seq_scale: float = 1.0  # encoder length = seq_len * scale (frontend stub)

    # VLM (llama-3.2 vision)
    cross_attn_every: int = 0   # every k-th layer is a cross-attn layer
    n_vision_tokens: int = 0

    # numerics / training
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # performance knobs (hillclimb surface)
    attn_chunk_q: int = 1024    # flash-attention query chunk
    attn_chunk_k: int = 1024    # flash-attention kv chunk
    flash_threshold: int = 8192  # use chunked attention when seq > this
    remat: str = "block"        # none | block
    grad_accum: int = 1         # microbatch count (train)
    decode_seq_shard: bool = True  # shard long KV caches over the model axis
    # sequence parallelism (§Perf): shard activations' S dim over 'model' and
    # replicate K/V per layer instead of head-sharding — removes the
    # per-chunk partial-sum all-reduces GSPMD emits when n_(kv_)heads do not
    # divide the model axis.  dp_axes names the batch axes of the mesh.
    seq_parallel: bool = False
    dp_axes: Tuple[str, ...] = ("data",)
    flash_skip: bool = False    # skip fully-masked flash chunks (triangle/window)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
        if self.family == "hybrid" and self.lru_width == 0:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scan_plan(self) -> dict:
        """Superblock scan plan: {head, n_sb, pattern, tail}.

        Heterogeneous stacks (vlm cross-attn every k-th, hybrid patterns, MoE
        first-dense) scan over homogeneous *superblocks*; leftovers run
        unscanned as explicit head/tail layers.
        """
        if self.family == "vlm" and self.cross_attn_every:
            k = self.cross_attn_every
            assert self.n_layers % k == 0
            return dict(head=(), n_sb=self.n_layers // k,
                        pattern=("cross",) + ("self",) * (k - 1), tail=())
        if self.family == "hybrid" and self.block_pattern:
            k = len(self.block_pattern)
            n_sb, rem = divmod(self.n_layers, k)
            return dict(head=(), n_sb=n_sb, pattern=self.block_pattern,
                        tail=self.block_pattern[:rem])
        if self.family == "moe":
            fd = self.first_dense_layers
            return dict(head=("dense_ffn",) * fd, n_sb=self.n_layers - fd,
                        pattern=("moe",), tail=())
        if self.family == "ssm":
            return dict(head=(), n_sb=self.n_layers, pattern=("mamba",), tail=())
        return dict(head=(), n_sb=self.n_layers, pattern=("self",), tail=())
