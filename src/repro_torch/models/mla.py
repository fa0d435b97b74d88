"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

KV is compressed into a rank-``kv_lora_rank`` latent c_kv plus one shared
RoPE key head; the decode cache stores only (c_kv, k_rope).

- Prefill/train: materialize per-head k_nope/v from the latent.
- Decode: *absorbed* form: fold W_uk into the query and W_uv into the
  output so attention runs directly in latent space; per-step cost is
  O(S * r) instead of O(S * H * dh).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, spmd
from repro_torch.models.layers import cache_write, f32, init_dense, rms_norm, rope, torch_dtype

__all__ = ["init_mla", "mla_attention", "mla_decode", "mla_nope_dim"]


def mla_nope_dim(cfg) -> int:
    return cfg.d_head  # qk_nope_head_dim == v_head_dim == d_head (V2-Lite: 128)


def init_mla(gen, cfg):
    D, H, r, dr = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.rope_head_dim
    dn = mla_nope_dim(cfg)
    dt = torch_dtype(cfg.dtype)
    return {
        "w_q": init_dense(gen, D, H * (dn + dr), dt),
        "w_dkv": init_dense(gen, D, r + dr, dt),
        "kv_norm": torch.ones((r,), dtype=dt, device=gen.device),
        "w_uk": init_dense(gen, r, H * dn, dt),
        "w_uv": init_dense(gen, r, H * dn, dt),
        "w_o": init_dense(gen, H * dn, D, dt),
    }


def _project_latent(p, x, cfg):
    """x [B,S,D] -> (c_kv [B,S,r], k_rope [B,S,1,dr])."""
    r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    dkv = x @ p["w_dkv"]
    c_kv = rms_norm(dkv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = dkv[..., r:].reshape(x.shape[0], x.shape[1], 1, dr)
    return c_kv, k_rope


def _queries(p, x, cfg, positions):
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, mla_nope_dim(cfg), cfg.rope_head_dim
    q = (x @ p["w_q"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_attention(p, x, cfg, positions, *, flash=False, q_chunk=1024, k_chunk=1024):
    """Train/prefill MLA with materialized per-head K/V."""
    B, S, D = x.shape
    H, dn, dr = cfg.n_heads, mla_nope_dim(cfg), cfg.rope_head_dim
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _project_latent(p, x, cfg)
    k_rope = rope(k_rope, positions, cfg.rope_theta)

    k_nope = (c_kv @ p["w_uk"]).reshape(B, S, H, dn)
    v = (c_kv @ p["w_uv"]).reshape(B, S, H, dn)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)

    if flash:
        out = layers.flash_attention(q, k, v, causal=True, q_chunk=q_chunk, k_chunk=k_chunk,
                                     skip_masked=cfg.flash_skip)
    else:
        out = layers.attention(q, k, v, causal=True)
    return out.reshape(B, S, H * dn) @ p["w_o"]


def mla_decode(p, x, cfg, cache, pos):
    """Absorbed-form decode.  cache = {'c_kv': [B,S,r], 'k_rope': [B,S,dr]},
    written in place at ``pos``.

    scores = q_nope W_uk^T c_kv / ... + q_rope k_rope;  out = probs c_kv W_uv.
    """
    B, _, D = x.shape
    H, dn, dr, r = cfg.n_heads, mla_nope_dim(cfg), cfg.rope_head_dim, cfg.kv_lora_rank
    positions = torch.full((B, 1), pos, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)     # [B,1,H,dn/dr]
    c_new, k_rope_new = _project_latent(p, x, cfg)
    k_rope_new = rope(k_rope_new, positions, cfg.rope_theta)

    ctx = spmd.active()
    split = ctx.seq_split(cache["c_kv"])
    if split:   # slots split over 'model': the owner writes, each scores its own
        c_kv, off, _ = ctx.cache_view(cache["c_kv"])
        k_rope, _, _ = ctx.cache_view(cache["k_rope"])
    else:
        c_kv, off = cache["c_kv"], 0
        k_rope = cache["k_rope"]
    if off <= pos < off + c_kv.shape[1]:
        cache_write(c_kv, c_new, pos - off)
        cache_write(k_rope, k_rope_new[:, :, 0, :], pos - off)
    S = c_kv.shape[1]                                     # [B,S,r], [B,S,dr]

    w_uk = p["w_uk"].reshape(r, H, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)          # absorb W_uk
    s = (
        torch.einsum("bhr,bsr->bhs", f32(q_lat), f32(c_kv))
        + torch.einsum("bhd,bsd->bhs", f32(q_rope[:, 0]), f32(k_rope))
    ) * (dn + dr) ** -0.5
    ok = torch.arange(S, device=x.device) + off <= pos
    s = s.masked_fill(~ok[None, None], -1e30)
    if split:
        o_lat = ctx.softmax_combine(s, c_kv, "bhs,bsr->bhr").to(c_kv.dtype)
    else:
        probs = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", probs.to(c_kv.dtype), c_kv)
    w_uv = p["w_uv"].reshape(r, H, dn)
    out = torch.einsum("bhr,rhd->bhd", o_lat, w_uv).reshape(B, 1, H * dn)
    return out @ p["w_o"], cache
