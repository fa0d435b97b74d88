"""Analytic per-arch FLOP / HBM-byte model (the JAX package's closed form,
copied: pure numpy).

``param_count`` / ``active_param_count`` count the parameters of the exact
stack the models build; ``cell_cost`` gives a (mode, seq, batch) cell's
global FLOPs and HBM bytes per step.  MODEL_FLOPS = 6·N·D (dense) or
6·N_active·D (MoE) is reported alongside as the "useful" floor.  On the
card the port's decode bound is a step's parameter bytes over the HBM rate.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["cell_cost", "param_count", "active_param_count"]


def _attn_params(cfg) -> int:
    D, H, KVH, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.attn_kind == "mla":
        r, dr, dn = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.d_head
        return D * H * (dn + dr) + D * (r + dr) + r * H * dn * 2 + H * dn * D
    return D * H * dh + 2 * D * KVH * dh + H * dh * D


def _mlp_params(cfg, d_ff) -> int:
    return 3 * cfg.d_model * d_ff


def _layer_params(cfg, kind: str) -> int:
    D = cfg.d_model
    if kind in ("self", "enc", "attn_local"):
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    if kind == "dense_ffn":
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    if kind == "moe":
        routed = cfg.n_experts * 3 * D * cfg.moe_d_ff
        shared = 3 * D * cfg.moe_d_ff * cfg.n_shared_experts
        return _attn_params(cfg) + routed + shared + D * cfg.n_experts
    if kind == "cross":
        return _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    if kind == "dec":
        return 2 * _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    if kind == "rglru":
        W = cfg.lru_width
        return 2 * D * W + 2 * W * W + W * D + _mlp_params(cfg, cfg.d_ff)
    if kind == "mamba":
        DI, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        return D * (2 * DI + 2 * N + Hs) + DI * D
    raise ValueError(kind)


def _kinds(cfg) -> list[str]:
    if cfg.family == "encdec":
        return ["enc"] * cfg.n_layers + ["dec"] * cfg.n_layers
    plan = cfg.scan_plan()
    return list(plan["head"]) + list(plan["pattern"]) * plan["n_sb"] + list(plan["tail"])


def param_count(cfg: ModelConfig) -> int:
    emb = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    return emb + sum(_layer_params(cfg, k) for k in _kinds(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """MoE: only top_k routed experts + shared are active per token."""
    total = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    D = cfg.d_model
    for k in _kinds(cfg):
        if k == "moe":
            routed = cfg.top_k * 3 * D * cfg.moe_d_ff
            shared = 3 * D * cfg.moe_d_ff * cfg.n_shared_experts
            total += _attn_params(cfg) + routed + shared + D * cfg.n_experts
        else:
            total += _layer_params(cfg, k)
    return total


# ---------------------------------------------------------------------------
def _attn_flops_layer(cfg, kind, S, ctx_len) -> float:
    """Score+PV flops for one layer, per sequence (matmul params handled via
    active params).  Full attention computes the full SxS grid (the flash
    kernel masks, it does not skip — baseline honesty; §Perf fixes one cell)."""
    H, dh = cfg.n_heads, cfg.d_head
    if kind in ("rglru", "mamba"):
        return 0.0
    if kind == "cross":
        return 2 * 2 * S * ctx_len * H * dh
    if kind == "dec":
        return 2 * 2 * S * S * H * dh + 2 * 2 * S * ctx_len * H * dh
    kv = min(cfg.window, S) if (cfg.window and kind in ("self", "moe", "attn_local")) else S
    if cfg.flash_skip and S > cfg.flash_threshold:
        # triangle/window scheduling: only non-fully-masked chunks computed
        if cfg.window:
            kv = min(kv + cfg.attn_chunk_q + cfg.attn_chunk_k, S)
        else:
            kv = (S + cfg.attn_chunk_q) / 2
    if cfg.attn_kind == "mla":
        dh_eff = cfg.d_head + cfg.rope_head_dim
        return 2 * 2 * S * kv * H * dh_eff
    return 2 * 2 * S * kv * H * dh


def _recurrent_flops_layer(cfg, kind, S) -> float:
    if kind == "mamba":
        Q = cfg.ssm_chunk
        Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        intra = 2 * S * Q * N + 2 * S * Q * Hs * P   # CB^T + scores@x per chunk-row
        inter = 2 * S * Hs * P * N * 2               # state build + C·h
        return intra + inter
    if kind == "rglru":
        return 8 * S * cfg.lru_width                  # gates/scan elementwise
    return 0.0


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops: float            # global FLOPs per step (compute roofline numerator)
    hbm_bytes: float        # global HBM traffic per step
    model_flops: float      # 6·N_active·D(tokens) — the useful floor
    params: int
    active_params: int

    def as_dict(self):
        return dataclasses.asdict(self)


def cell_cost(cfg: ModelConfig, mode: str, seq: int, batch: int, *, grad_accum: int = 1,
              enc_len: int = 0, vis_tokens: int = 0) -> CellCost:
    """Global per-step cost for one (arch, shape) cell."""
    N = param_count(cfg)
    Na = active_param_count(cfg)
    kinds = _kinds(cfg)
    tokens = batch * seq

    # --- matmul flops from active params: 2·Na·tokens fwd ------------------
    if mode == "train":
        # fwd (2) + bwd (4) + remat re-fwd (2) = 8·Na·tokens
        mm = 8 * Na * tokens
        attn = sum(_attn_flops_layer(cfg, k, seq, enc_len or vis_tokens) for k in kinds) * batch * 4
        rec = sum(_recurrent_flops_layer(cfg, k, seq) for k in kinds) * batch * 4
        flops = mm + attn + rec
        model_flops = 6 * Na * tokens
        # HBM: params read ~(fwd+bwd+remat fwd = 3) + grads + opt update (rw) +
        # activations (saved residuals rw)
        act = len(kinds) * tokens * cfg.d_model * 2 * 4
        hbm = N * 2 * 3 * grad_accum + N * (4 * 3 + 2 * 2) + act
    elif mode == "prefill":
        mm = 2 * Na * tokens
        attn = sum(_attn_flops_layer(cfg, k, seq, enc_len or vis_tokens) for k in kinds) * batch
        rec = sum(_recurrent_flops_layer(cfg, k, seq) for k in kinds) * batch
        flops = mm + attn + rec
        model_flops = 2 * Na * tokens
        hbm = N * 2 + tokens * cfg.d_model * 2 * len(kinds) * 2
    else:  # decode: one token, cache of length seq
        tokens = batch * 1
        mm = 2 * Na * tokens
        H, dh, KVH = cfg.n_heads, cfg.d_head, cfg.n_kv_heads
        attn = rec = cache_bytes = 0.0
        for k in kinds:
            if k in ("self", "dense_ffn", "moe", "attn_local", "dec"):
                kv = min(cfg.window, seq) if cfg.window else seq
                if cfg.attn_kind == "mla":
                    r = cfg.kv_lora_rank
                    attn += 2 * 2 * kv * H * r * batch
                    cache_bytes += kv * (r + cfg.rope_head_dim) * 2 * batch * 2  # r/w
                else:
                    attn += 2 * 2 * kv * H * dh * batch
                    cache_bytes += kv * KVH * dh * 2 * 2 * batch * 2
                if k == "dec":
                    attn += 2 * 2 * enc_len * H * dh * batch
                    cache_bytes += enc_len * KVH * dh * 2 * 2 * batch
            if k == "cross":
                attn += 2 * 2 * vis_tokens * H * dh * batch
                cache_bytes += vis_tokens * KVH * dh * 2 * 2 * batch
            if k == "mamba":
                Hs, P, Ns = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
                rec += 4 * Hs * P * Ns * batch
                cache_bytes += Hs * P * Ns * 4 * 2 * batch
            if k == "rglru":
                rec += 8 * cfg.lru_width * batch
                cache_bytes += cfg.lru_width * 4 * 2 * batch
        flops = mm + attn + rec
        model_flops = 2 * Na * tokens
        hbm = N * 2 + cache_bytes + tokens * cfg.d_model * 2 * len(kinds)

    return CellCost(flops=float(flops), hbm_bytes=float(hbm),
                    model_flops=float(model_flops), params=N, active_params=Na)
