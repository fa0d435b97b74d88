"""Shared transformer building blocks (plain PyTorch, dict params).

The port of the JAX package's ``repro.models.layers``, op for op:

- activations in cfg.dtype, reductions (softmax / norms) in float32, and the
  casts where the JAX code casts (a product with
  ``preferred_element_type=float32`` takes float32 operands here, so its
  products and sums are float32 as XLA's are);
- GQA everywhere: q [B,S,KVH,G,dh] against k/v [B,S,KVH,dh];
- two attention paths: dense einsum (short seq) and flash (loops over query
  and kv chunks with an online softmax) for long sequences, selected by
  cfg.flash_threshold;
- decode path: single-token query against a KV cache that is written in
  place (``cache_write``).

Init functions draw from an explicit ``torch.Generator`` on the device the
tensors are made on, at the JAX package's scales (not its values).
"""
from __future__ import annotations

import torch

__all__ = [
    "rms_norm", "rope", "swiglu", "attention", "flash_attention",
    "decode_attention", "cache_write", "init_dense", "init_attn", "init_mlp",
]

_NEG_INF = -1e30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(dtype) -> torch.dtype:
    """cfg.dtype ('bfloat16' / 'float32') or a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[dtype]


def scale_by(x, s: float):
    """x * s with s rounded to x's dtype first, as a weakly typed JAX scalar is."""
    return x * torch.tensor(s, dtype=x.dtype, device=x.device)


def f32(x):
    return x.to(torch.float32)


# ---------------------------------------------------------------- init utils
def normal(gen: torch.Generator, shape, std: float, dtype):
    """N(0, std^2) drawn in float32 on the generator's device, then cast."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
    return (x * std).to(torch_dtype(dtype))


def init_dense(gen, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return normal(gen, (d_in, d_out), scale, dtype)


def init_attn(gen, cfg):
    """GQA attention params: q/k/v/o projections (+ optional qk norms)."""
    dh, H, KVH, D = cfg.d_head, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    dt = torch_dtype(cfg.dtype)
    p = {
        "wq": init_dense(gen, D, H * dh, dt),
        "wk": init_dense(gen, D, KVH * dh, dt),
        "wv": init_dense(gen, D, KVH * dh, dt),
        "wo": init_dense(gen, H * dh, D, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=gen.device)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=gen.device)
    return p


def init_mlp(gen, d_model, d_ff, dtype):
    dt = torch_dtype(dtype)
    return {
        "w_gate": init_dense(gen, d_model, d_ff, dt),
        "w_up": init_dense(gen, d_model, d_ff, dt),
        "w_down": init_dense(gen, d_ff, d_model, dt),
    }


# ------------------------------------------------------------------- norms
def rms_norm(x, gamma, eps=1e-6):
    x32 = f32(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * gamma


# -------------------------------------------------------------------- RoPE
def rope(x, positions, theta=1e4):
    """x: [..., S, H, dh]; positions: [..., S] (broadcastable)."""
    dh = x.shape[-1]
    half = dh // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    angles = f32(positions)[..., :, None, None] * freqs  # [...,S,1,half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- MLP
def silu(x):
    """x * sigmoid(x) with the sigmoid as XLA expands ``jax.nn.silu``'s
    logistic: 1 / (1 + exp(-x)), each step rounded to x's dtype (in
    bfloat16 ``F.silu``, which rounds once, differs in ~1/3 of the values)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(p, x):
    g = silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


# --------------------------------------------------------------- attention
def _gqa_scores(q, k):
    """q [B,Sq,KVH,G,dh] x k [B,Sk,KVH,dh] -> [B,KVH,G,Sq,Sk] (f32)."""
    return torch.einsum("bqhgd,bkhd->bhgqk", f32(q), f32(k))


def _mask_bias(q_pos, k_pos, *, causal, window):
    """[Sq, Sk] additive bias from absolute positions."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, _NEG_INF))


def attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Dense-softmax GQA attention.  q [B,Sq,H,dh], k/v [B,Sk,KVH,dh(v)].

    q/k head dim may differ from v head dim (MLA concatenates rope dims onto
    q/k only); output uses v's head dim.
    """
    B, Sq, H, dh = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    G = H // KVH
    qg = scale_by(q.reshape(B, Sq, KVH, G, dh), dh ** -0.5)
    scores = _gqa_scores(qg, k)
    dev = q.device
    bias = _mask_bias(torch.arange(Sq, device=dev) + q_offset, torch.arange(k.shape[1], device=dev),
                      causal=causal, window=window)
    probs = torch.softmax(scores + bias[None, None, None], dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, dv)


def flash_attention(q, k, v, *, causal=True, window=0, q_chunk=1024, k_chunk=1024,
                    q_offset=0, skip_masked=False):
    """Online-softmax attention: O(S * chunk) memory, never materializes SxS.

    An outer loop over query chunks and an inner one over kv chunks (the JAX
    package's nested ``lax.scan``).  skip_masked=True skips the fully masked
    kv chunks (the JAX package's ``lax.cond``), decided here on the host from
    the chunks' positions.
    """
    B, Sq, H, dh = q.shape
    Sk, KVH, dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KVH
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    if Sq % q_chunk or Sk % k_chunk:
        raise ValueError(f"sequence lengths {Sq}, {Sk} must be multiples of the chunks "
                         f"{q_chunk}, {k_chunk}")
    nq, nk = Sq // q_chunk, Sk // k_chunk
    dev = q.device

    qg = scale_by(q.reshape(B, nq, q_chunk, KVH, G, dh), dh ** -0.5)
    ks = k.reshape(B, nk, k_chunk, KVH, dh)
    vs = v.reshape(B, nk, k_chunk, KVH, dv)
    outs = []
    for iq in range(nq):
        qc = qg[:, iq]                                   # [B, q_chunk, KVH, G, dh]
        q_lo = iq * q_chunk + q_offset
        q_pos = torch.arange(q_chunk, device=dev) + q_lo
        shape = (B, KVH, G, q_chunk)
        m = torch.full(shape, -float("inf"), dtype=torch.float32, device=dev)
        l = torch.zeros(shape, dtype=torch.float32, device=dev)
        acc = torch.zeros(shape + (dv,), dtype=torch.float32, device=dev)
        for ik in range(nk):
            k_lo = ik * k_chunk
            if skip_masked:
                needed = True
                if causal:
                    needed &= k_lo <= q_lo + q_chunk - 1       # chunk not in the future
                if window:
                    needed &= k_lo + k_chunk - 1 > q_lo - window  # chunk inside the window
                if not needed:
                    continue
            kc, vc = ks[:, ik], vs[:, ik]
            k_pos = torch.arange(k_chunk, device=dev) + k_lo
            s = _gqa_scores(qc, kc)                          # [B,KVH,G,qc,kc]
            s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)[None, None, None]
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            m_safe = torch.clamp(m_new, min=_NEG_INF)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.clamp(m, min=_NEG_INF) - m_safe)
            l = l * corr + torch.sum(p, dim=-1)
            pv = f32(torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-20)[..., None]     # [B,KVH,G,qc,dv]
        outs.append(out.to(v.dtype))
    out = torch.stack(outs, dim=1)                          # [B,nq,KVH,G,qc,dv]
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, H, dv)


def decode_attention(q, k_cache, v_cache, pos, *, window=0):
    """Single-token attention against the cache.  q [B,1,H,dh];
    k/v_cache [B,S,KVH,dh]; pos: int (tokens already in cache, including the
    one just written at index pos)."""
    B, _, H, dh = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = scale_by(q.reshape(B, KVH, G, dh), dh ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", f32(qg), f32(k_cache))
    k_pos = torch.arange(S, device=q.device)
    ok = k_pos <= pos
    if window:
        ok &= k_pos > pos - window
    s = s.masked_fill(~ok[None, None, None], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, dh)


def cache_write(cache, new, pos):
    """Write new [B,1,...] at time index pos of cache [B,S,...], in place.

    The JAX package blends a one-hot row in (``cache * (1 - onehot) + new *
    onehot``), which for finite values is this copy.  Returns the cache.
    """
    cache.narrow(1, int(pos), 1).copy_(new)
    return cache
