"""Model assembly: block kinds, their init, full-sequence apply and decode.

Every architecture is a stack of *superblocks* (cfg.scan_plan()), as in the
JAX package; here the stack is a ``ModuleList`` the model loops over (the
JAX package's ``lax.scan`` over stacked parameters), and each layer is a
``Block`` module holding its kind's parameters under the JAX package's
names.

Block kinds:
  self   — [RMSNorm -> GQA attn (full/sliding, RoPE, qk_norm) -> RMSNorm -> SwiGLU]
  moe    — attention (GQA or MLA per cfg.attn_kind) + MoE FFN
  cross  — gated cross-attention to stub modality tokens + gated MLP (VLM)
  rglru  — Griffin recurrent block + MLP
  mamba  — Mamba-2 SSD mixer (no separate FFN)
  enc    — bidirectional attention + MLP (whisper encoder)
  dec    — causal self-attn + cross-attn(enc) + MLP (whisper decoder)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers, mla as mla_lib, moe as moe_lib, rglru as rglru_lib
from repro_torch.models import spmd, ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention,
    cache_write,
    f32,
    init_attn,
    init_mlp,
    rms_norm,
    rope,
    scale_by,
    torch_dtype,
)

# the JAX package's names; ParamTree and Block are this port's modules
__all__ = ["init_block", "apply_block", "decode_block", "init_block_cache"]


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves become (trainable)
    parameters, subtrees child modules, under the same keys; ``tree[key]``
    reads either, so the functional code below takes it where the JAX
    package takes its dict.  A DTensor parameter (a model on a mesh) reads
    gathered whole (``spmd.local_param``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(key, nn.Parameter(value))

    def __getitem__(self, key):
        return spmd.local_param(getattr(self, key))

    def shard(self, key):
        """A tensor-parallel layer's weight: its 'model' shard
        (``Spmd.tp_shard``)."""
        return spmd.active().tp_shard(getattr(self, key))

    def replica(self, key):
        """A replicated leaf read inside a tensor-parallel layer
        (``Spmd.tp_replica``)."""
        return spmd.active().tp_replica(getattr(self, key))


class Block(ParamTree):
    """One layer of a kind: its parameters, ``forward`` (full sequence) and
    ``decode`` (one token against its cache)."""

    def __init__(self, kind: str, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.kind = kind
        self.cfg = cfg

    def forward(self, x, aux):
        return apply_block(self.kind, self, x, self.cfg, aux)

    def decode(self, x, cache, pos):
        return decode_block(self.kind, self, x, self.cfg, cache, pos)


def _dot(a, b):
    """a @ b after JAX's type promotion (e.g. float32 stub embeddings
    against bfloat16 weights); torch's matmul takes one dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# =========================================================================
# attention wrappers (GQA path)
# =========================================================================

def _sp_constraint(x, cfg):
    """Sequence-parallel layout (cfg.seq_parallel): batch over the dp axes,
    the sequence dim over 'model' -- this rank's slice of a tensor whose
    sequence it holds whole (the embeddings at the stack's entry; the
    residual stream then stays cut).  Without a mesh the identity."""
    return spmd.active().seq_slice(x) if cfg.seq_parallel else x


def _replicated_constraint(x, cfg):
    """Batch over the dp axes, the sequence whole: a rank's slice of K / V
    gathered over 'model' (all-gather, reduce-scatter of the gradient)."""
    return spmd.active().gather_seq(x) if cfg.seq_parallel else x


def _qkv(p, x, cfg, positions, *, tp=False):
    """q [B,S,H,dh], k / v [B,S,KVH,dh]; ``tp``: this rank's heads, from the
    'model' shards of the projections (the sequence as ``x`` holds it)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    w, norm = (p.shard, p.replica) if tp else (p.__getitem__, p.__getitem__)
    q = (x @ w("wq")).reshape(B, S, -1, dh)
    k = (x @ w("wk")).reshape(B, S, -1, dh)
    v = (x @ w("wv")).reshape(B, S, -1, dh)
    if cfg.qk_norm:
        q = rms_norm(q, norm("q_norm"), cfg.norm_eps)
        k = rms_norm(k, norm("k_norm"), cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if S > 1 and not tp:  # decode keeps its own cache layout; q keeps this rank's positions
        k = _replicated_constraint(k, cfg)
        v = _replicated_constraint(v, cfg)
    return q, k, v


def gqa_attention(p, x, cfg, positions, *, causal=True, window=0):
    """Self-attention of x [B,S,D].  Under tensor parallelism each 'model'
    rank attends with its heads (column-parallel wq / wk / wv) over the
    whole sequence, and its row-parallel wo's partial sum is reduced out."""
    ctx = spmd.active()
    tp = ctx.tp_on("attention")
    if not tp and ctx.splits_rows(x):
        return ctx.rows_split(lambda h: gqa_attention(p, h, cfg, positions, causal=causal,
                                                      window=window), x)
    q_off = 0
    if tp:
        x = ctx.tp_in(x)
        if ctx.seq:     # the whole sequence: its global positions
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
    else:   # under seq_parallel q holds this rank's positions, k / v all of them
        q_off = ctx.seq_start(x.shape[1])
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions, tp=tp)
    if k.shape[1] > cfg.flash_threshold:
        out = layers.flash_attention(q, k, v, causal=causal, window=window,
                                     q_chunk=min(cfg.attn_chunk_q, S), k_chunk=cfg.attn_chunk_k,
                                     q_offset=q_off, skip_masked=cfg.flash_skip)
    else:
        out = attention(q, k, v, causal=causal, window=window, q_offset=q_off)
    out = out.reshape(B, S, -1)
    if tp:
        return ctx.tp_out(out @ p.shard("wo"))
    return out @ p["wo"]


def _on_full_sequence(fn, x, cfg):
    """fn(x) for a block that is not token-local (a recurrence, MLA) and
    gathers its weights over 'model': under seq_parallel it runs on the
    sequence gathered over 'model' and each rank keeps its slice; under TP
    without it the 'model' ranks split the rows (``Spmd.rows_split``);
    otherwise fn(x)."""
    ctx = spmd.active()
    if ctx.seq:
        return ctx.seq_slice(fn(ctx.gather_seq(x)))
    if ctx.splits_rows(x):
        return ctx.rows_split(fn, x)
    return fn(x)


def _cross(p, x, c, cfg):
    """cross_attention, which gathers its weights over 'model': under TP the
    'model' ranks split the rows of x and of the context ``c``."""
    ctx = spmd.active()
    if ctx.splits_rows(x):
        return ctx.rows_split(lambda h, k: cross_attention(p, h, k, cfg), x, c)
    return cross_attention(p, x, c, cfg)


def cross_attention(p, x, ctx, cfg):
    """q from x [B,S,D], k/v from ctx [B,Sc,D] (no positions, no mask)."""
    B, S, _ = x.shape
    Sc = ctx.shape[1]
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = _dot(ctx, p["wk"]).reshape(B, Sc, KVH, dh)
    v = _dot(ctx, p["wv"]).reshape(B, Sc, KVH, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    out = attention(q, k, v, causal=False)
    return _dot(out.reshape(B, S, H * dh), p["wo"])


def _ring_mask(pos, W, device):
    """Ring-buffer cache slot validity: every live slot is inside the window
    by construction; slot j holds absolute position pos - ((pos - j) mod W)."""
    j = torch.arange(W, device=device)
    p_j = pos - torch.remainder(pos - j, W)
    return p_j >= 0


def gqa_decode(p, x, cfg, cache, pos):
    """One-token attention with KV cache (written in place).

    Windowed attention (cfg.window > 0) uses a ring buffer of `window` slots
    (RoPE applied at write time with absolute positions, so rotation is
    transparent); full attention uses a full-length cache.
    """
    B = x.shape[0]
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    ctx = spmd.active()
    if ctx.seq_split(cache["k"]):
        return _gqa_decode_split(p, cfg, cache, pos, q, k, v, ctx)
    W = cache["k"].shape[1]
    ring = cfg.window != 0
    slot = pos % W if ring else pos
    kc = cache_write(cache["k"], k, slot)
    vc = cache_write(cache["v"], v, slot)
    if ring:
        ok = _ring_mask(pos, W, x.device)
    else:
        ok = torch.arange(W, device=x.device) <= pos
    qg = scale_by(q.reshape(B, KVH, H // KVH, dh), dh ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", f32(qg), f32(kc))
    s = s.masked_fill(~ok[None, None, None], -1e30)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(vc.dtype), vc)
    out = out.reshape(B, 1, H * dh) @ p["wo"]
    return out, cache


def _gqa_decode_split(p, cfg, cache, pos, q, k, v, ctx):
    """gqa_decode against a cache whose slots are split over 'model': the
    rank owning the slot writes it, each scores its own slots."""
    B = q.shape[0]
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kc, off, W = ctx.cache_view(cache["k"])
    vc, _, _ = ctx.cache_view(cache["v"])
    ring = cfg.window != 0
    slot = pos % W if ring else pos
    if off <= slot < off + kc.shape[1]:
        cache_write(kc, k, slot - off)
        cache_write(vc, v, slot - off)
    j = torch.arange(kc.shape[1], device=q.device) + off
    ok = (pos - torch.remainder(pos - j, W) >= 0) if ring else j <= pos
    qg = scale_by(q.reshape(B, KVH, H // KVH, dh), dh ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", f32(qg), f32(kc))
    s = s.masked_fill(~ok[None, None, None], -1e30)
    out = ctx.softmax_combine(s, vc, "bhgk,bkhd->bhgd").to(vc.dtype)
    return out.reshape(B, 1, H * dh) @ p["wo"], cache


def cfg_max_cache(cfg) -> int:
    """Cache length policy: ring of `window` slots for windowed attention."""
    return cfg.window if cfg.window else 1 << 62


# =========================================================================
# block init / apply / decode — dispatched on kind
# =========================================================================

def init_block(gen, cfg: ModelConfig, kind: str):
    """The parameter tree of one layer of ``kind``, drawn from ``gen`` on its
    device."""
    dt = torch_dtype(cfg.dtype)
    D = cfg.d_model
    ln = lambda: torch.ones((D,), dtype=dt, device=gen.device)  # noqa: E731
    zero = lambda: torch.zeros((), dtype=dt, device=gen.device)  # noqa: E731

    if kind in ("self", "dense_ffn"):  # dense_ffn: a MoE model's first dense layer(s)
        return {"ln1": ln(), "attn": _init_attn_kind(gen, cfg), "ln2": ln(),
                "mlp": init_mlp(gen, D, cfg.d_ff, dt)}
    if kind == "moe":
        return {"ln1": ln(), "attn": _init_attn_kind(gen, cfg), "ln2": ln(),
                "moe": moe_lib.init_moe(gen, cfg)}
    if kind == "cross":
        return {"ln1": ln(), "xattn": init_attn(gen, cfg), "gate_attn": zero(),
                "ln2": ln(), "mlp": init_mlp(gen, D, cfg.d_ff, dt), "gate_mlp": zero()}
    if kind == "rglru":
        return {"ln1": ln(), "rec": rglru_lib.init_rglru_block(gen, cfg), "ln2": ln(),
                "mlp": init_mlp(gen, D, cfg.d_ff, dt)}
    if kind in ("attn_local", "enc"):  # griffin local attention; whisper encoder
        return {"ln1": ln(), "attn": init_attn(gen, cfg), "ln2": ln(),
                "mlp": init_mlp(gen, D, cfg.d_ff, dt)}
    if kind == "mamba":
        return {"ln1": ln(), "mixer": ssm_lib.init_mamba(gen, cfg)}
    if kind == "dec":
        return {"ln1": ln(), "attn": init_attn(gen, cfg), "lnx": ln(),
                "xattn": init_attn(gen, cfg), "ln2": ln(),
                "mlp": init_mlp(gen, D, cfg.d_ff, dt)}
    raise ValueError(kind)


def _init_attn_kind(gen, cfg):
    if cfg.attn_kind == "mla":
        return mla_lib.init_mla(gen, cfg)
    return init_attn(gen, cfg)


def _self_attn_apply(p, x, cfg, positions, *, window=None):
    window = cfg.window if window is None else window
    if cfg.attn_kind == "mla":
        def mla(h):
            pos = torch.arange(h.shape[1], device=h.device)[None, :]
            flash = h.shape[1] > cfg.flash_threshold
            return mla_lib.mla_attention(p, h, cfg, pos if spmd.active().seq
                                         else positions, flash=flash,
                                         q_chunk=cfg.attn_chunk_q, k_chunk=cfg.attn_chunk_k)
        return _on_full_sequence(mla, x, cfg)
    return gqa_attention(p, x, cfg, positions, causal=True, window=window)


def apply_block(kind: str, p, x, cfg: ModelConfig, aux: dict):
    """Full-sequence (train/prefill) block application.  x [B,S,D]."""
    positions = aux["positions"]
    if kind in ("self", "dense_ffn"):
        x = x + _self_attn_apply(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, positions)
        x = x + layers.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, 0.0
    if kind == "moe":
        x = x + _self_attn_apply(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, positions)
        y, aux_loss = moe_lib.moe_ffn(p["moe"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                                      return_aux=True)
        return x + y, aux_loss
    if kind == "cross":
        ctx = aux["ctx"]
        x = x + torch.tanh(p["gate_attn"]) * _cross(
            p["xattn"], rms_norm(x, p["ln1"], cfg.norm_eps), ctx, cfg)
        x = x + torch.tanh(p["gate_mlp"]) * layers.swiglu(
            p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, 0.0
    if kind == "rglru":
        x = x + _on_full_sequence(lambda h: rglru_lib.rglru_block(p["rec"], h, cfg),
                                  rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
        x = x + layers.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, 0.0
    if kind == "attn_local":
        x = x + gqa_attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                              positions, causal=True, window=cfg.window)
        x = x + layers.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, 0.0
    if kind == "mamba":
        x = x + _on_full_sequence(lambda h: ssm_lib.mamba_block(p["mixer"], h, cfg),
                                  rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
        return x, 0.0
    if kind == "enc":
        x = x + gqa_attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                              positions, causal=False, window=0)
        x = x + layers.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, 0.0
    if kind == "dec":
        x = x + gqa_attention(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                              positions, causal=True, window=0)
        x = x + _cross(p["xattn"], rms_norm(x, p["lnx"], cfg.norm_eps), aux["ctx"], cfg)
        x = x + layers.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, 0.0
    raise ValueError(kind)


# =========================================================================
# decode: per-block caches
# =========================================================================

def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, dtype,
                     enc_len: int = 0, device=None):
    KVH, dh = cfg.n_kv_heads, cfg.d_head
    dt = torch_dtype(dtype)
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if kind in ("self", "dense_ffn", "moe", "attn_local"):
        if cfg.attn_kind == "mla" and kind in ("self", "dense_ffn", "moe"):
            return {"c_kv": zeros(batch, max_seq, cfg.kv_lora_rank),
                    "k_rope": zeros(batch, max_seq, cfg.rope_head_dim)}
        W = min(max_seq, cfg_max_cache(cfg))
        return {"k": zeros(batch, W, KVH, dh), "v": zeros(batch, W, KVH, dh)}
    if kind == "cross":
        # static cross K/V over the modality tokens, filled at prefill
        n = cfg.n_vision_tokens
        return {"xk": zeros(batch, n, KVH, dh), "xv": zeros(batch, n, KVH, dh)}
    if kind == "rglru":
        return rglru_lib.init_rglru_cache(cfg, batch, dt, device)
    if kind == "mamba":
        return ssm_lib.init_mamba_cache(cfg, batch, dt, device)
    if kind == "dec":
        return {"k": zeros(batch, max_seq, KVH, dh), "v": zeros(batch, max_seq, KVH, dh),
                "xk": zeros(batch, enc_len, KVH, dh), "xv": zeros(batch, enc_len, KVH, dh)}
    raise ValueError(kind)


def _cross_decode(p, x, cfg, xk, xv):
    B = x.shape[0]
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, 1, H, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    qg = scale_by(q.reshape(B, KVH, H // KVH, dh), dh ** -0.5)
    ctx = spmd.active()
    if ctx.seq_split(xk):
        xk, xv = ctx.cache_view(xk)[0], ctx.cache_view(xv)[0]
        s = torch.einsum("bhgd,bkhd->bhgk", f32(qg), f32(xk))
        out = ctx.softmax_combine(s, xv, "bhgk,bkhd->bhgd").to(xv.dtype)
        return _dot(out.reshape(B, 1, H * dh), p["wo"])
    s = torch.einsum("bhgd,bkhd->bhgk", f32(qg), f32(xk))
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(xv.dtype), xv)
    return _dot(out.reshape(B, 1, H * dh), p["wo"])


def decode_block(kind: str, p, x, cfg: ModelConfig, cache, pos):
    """One-token block step.  x [B,1,D] -> (x', cache), the cache updated in
    place."""
    if kind in ("self", "dense_ffn", "moe", "attn_local"):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.attn_kind == "mla":
            y, cache = mla_lib.mla_decode(p["attn"], h, cfg, cache, pos)
        else:
            y, cache = gqa_decode(p["attn"], h, cfg, cache, pos)
        x = x + y
        h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            y2 = moe_lib.moe_ffn(p["moe"], h2, cfg, no_drop=True)  # inference: never drop
        else:
            y2 = layers.swiglu(p["mlp"], h2)
        return x + y2, cache
    if kind == "cross":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + torch.tanh(p["gate_attn"]) * _cross_decode(p["xattn"], h, cfg, cache["xk"],
                                                          cache["xv"])
        x = x + torch.tanh(p["gate_mlp"]) * layers.swiglu(
            p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, cache
    if kind == "rglru":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, cache = rglru_lib.rglru_decode(p["rec"], h, cfg, cache)
        x = x + y
        x = x + layers.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, cache
    if kind == "mamba":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, cache = ssm_lib.mamba_decode(p["mixer"], h, cfg, cache)
        return x + y, cache
    if kind == "dec":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, _ = gqa_decode(p["attn"], h, cfg, cache, pos)
        x = x + y
        x = x + _cross_decode(p["xattn"], rms_norm(x, p["lnx"], cfg.norm_eps), cfg,
                              cache["xk"], cache["xv"])
        x = x + layers.swiglu(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
        return x, cache
    raise ValueError(kind)
