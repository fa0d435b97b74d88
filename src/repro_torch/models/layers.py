"""Shared transformer building blocks (plain PyTorch, dict params).

The port of the JAX package's ``repro.models.layers``, op for op:

- activations in cfg.dtype, reductions (softmax / norms) in float32, and the
  casts where the JAX code casts (a product with
  ``preferred_element_type=float32`` takes float32 operands here, so its
  products and sums are float32 as XLA's are);
- GQA everywhere: q [B,S,KVH,G,dh] against k/v [B,S,KVH,dh];
- two attention paths: dense einsum (short seq) and flash (a loop over kv
  chunks, each taken by slabs of query chunks, with an online softmax) for
  long sequences, selected by cfg.flash_threshold;
- decode path: single-token query against a KV cache that is written in
  place (``cache_write``).

Init functions draw from an explicit ``torch.Generator`` on the device the
tensors are made on, at the JAX package's scales (not its values).
"""
from __future__ import annotations

import torch

from repro_torch.models import spmd

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


def swiglu(p, x, layer: str = "mlp"):
    """The gated MLP of x [B,S,D].  Where ``layer`` runs tensor parallel
    (``spmd``'s layout) each 'model' rank computes its d_ff columns
    (column-parallel w_gate / w_up, row-parallel w_down) between "copy in"
    and "reduce out"."""
    ctx = spmd.active()
    if ctx.tp_on(layer):
        h = ctx.tp_in(x)
        g = silu(h @ p.shard("w_gate"))
        return ctx.tp_out((g * (h @ p.shard("w_up"))) @ p.shard("w_down"))
    if ctx.splits_rows(x):      # others run TP: the 'model' ranks split the rows
        return ctx.rows_split(lambda h: swiglu(p, h, layer), x)
    g = silu(x @ p["w_gate"])
    return (g * (x @ p["w_up"])) @ p["w_down"]


# ------------------------------------------------------------------ scans
def _slice(x, dim: int, start, stop, step=1):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a, b, dim: int):
    """a0 b0 a1 b1 ... along ``dim`` (a as long as b or one longer)."""
    n = b.shape[dim]
    out = torch.stack([_slice(a, dim, 0, n), b], dim=dim + 1).flatten(dim, dim + 1)
    return out if a.shape[dim] == n else torch.cat([out, _slice(a, dim, n, None)], dim=dim)


def associative_scan(combine, elems: tuple, dim: int) -> tuple:
    """Inclusive scan of ``elems`` (tensors of one length along ``dim``)
    under the associative ``combine(earlier, later)``: the JAX package's
    ``lax.associative_scan``, the same recursion (adjacent pairs combined,
    the half-length scan, then the even elements), so each element is
    combined in the same tree; 2 log2(S) levels of torch ops, not S."""
    n = elems[0].shape[dim]
    if n < 2:
        return tuple(elems)
    reduced = combine(tuple(_slice(e, dim, 0, -1, 2) for e in elems),
                      tuple(_slice(e, dim, 1, None, 2) for e in elems))
    odd = associative_scan(combine, reduced, dim)
    if n % 2 == 0:
        even = combine(tuple(_slice(e, dim, 0, -1) for e in odd),
                       tuple(_slice(e, dim, 2, None, 2) for e in elems))
    else:
        even = combine(odd, tuple(_slice(e, dim, 2, None, 2) for e in elems))
    even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


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


# query chunks whose scores against one kv chunk are computed at once
FLASH_SLAB_CHUNKS = 8


def flash_attention(q, k, v, *, causal=True, window=0, q_chunk=1024, k_chunk=1024,
                    q_offset=0, skip_masked=False):
    """Online-softmax attention: O(S * chunk) memory, never materializes SxS.

    Each query chunk takes the kv chunks in ascending order (the JAX
    package's nested ``lax.scan``: outer over query chunks, inner over kv
    chunks), but the loop runs over the kv chunks: each is taken by the
    contiguous range of query chunks that need it, ``FLASH_SLAB_CHUNKS`` of
    them at a time, so every query row sees the same sequence of updates.
    skip_masked=True skips the fully masked kv chunks of a query chunk (the
    JAX package's ``lax.cond``), decided here on the host from the chunks'
    positions.
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

    def needed(iq, ik):
        q_lo, k_lo = iq * q_chunk + q_offset, ik * k_chunk
        ok = True
        if causal:
            ok &= k_lo <= q_lo + q_chunk - 1           # chunk not in the future
        if window:
            ok &= k_lo + k_chunk - 1 > q_lo - window      # chunk inside the window
        return ok

    qg = scale_by(q.reshape(B, Sq, KVH, G, dh), dh ** -0.5)
    ks = k.reshape(B, nk, k_chunk, KVH, dh)
    vs = v.reshape(B, nk, k_chunk, KVH, dv)
    shape = (B, KVH, G, Sq)
    # the online-softmax state of each query chunk
    m = list(torch.full(shape, -float("inf"), dtype=torch.float32, device=dev)
             .split(q_chunk, dim=-1))
    l = list(torch.zeros(shape, dtype=torch.float32, device=dev).split(q_chunk, dim=-1))
    acc = list(torch.zeros(shape + (dv,), dtype=torch.float32, device=dev)
               .split(q_chunk, dim=-2))
    for ik in range(nk):
        iqs = [iq for iq in range(nq) if not skip_masked or needed(iq, ik)]
        kc, vc = ks[:, ik], vs[:, ik]
        k_pos = torch.arange(k_chunk, device=dev) + ik * k_chunk
        for j in range(0, len(iqs), FLASH_SLAB_CHUNKS):
            a, b = iqs[j], iqs[min(j + FLASH_SLAB_CHUNKS, len(iqs)) - 1] + 1
            q_pos = torch.arange(a * q_chunk, b * q_chunk, device=dev) + q_offset
            s = _gqa_scores(qg[:, a * q_chunk:b * q_chunk], kc)  # [B,KVH,G,rows,kc]
            s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window)[None, None, None]
            m_old = torch.cat(m[a:b], dim=-1)
            m_new = torch.maximum(m_old, torch.amax(s, dim=-1))
            m_safe = torch.clamp(m_new, min=_NEG_INF)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.clamp(m_old, min=_NEG_INF) - m_safe)
            l_new = torch.cat(l[a:b], dim=-1) * corr + torch.sum(p, dim=-1)
            pv = f32(torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype), vc))
            acc_new = torch.cat(acc[a:b], dim=-2) * corr[..., None] + pv
            m[a:b] = m_new.split(q_chunk, dim=-1)
            l[a:b] = l_new.split(q_chunk, dim=-1)
            acc[a:b] = acc_new.split(q_chunk, dim=-2)
    out = torch.cat(acc, dim=-2) / torch.clamp(torch.cat(l, dim=-1), min=1e-20)[..., None]
    return out.to(v.dtype).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv)


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
