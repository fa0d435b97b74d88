"""Mamba-2 / SSD (state-space duality, arXiv:2405.21060) block.

Chunked SSD: sequence split into chunks of length Q; within a chunk the
recurrence is computed in its dual quadratic-attention form (masked
matmuls); chunk boundary states propagate through the JAX package's
associative scan over the chunks (``layers.associative_scan``).  Decode is the O(1)
recurrent update: no KV cache.

Shapes: x [B,S,HP] split into H heads of P dims; B_ssm/C [B,S,N] (single
group); dt [B,S,H]; A [H] (negative reals).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (associative_scan, f32, init_dense, normal, rms_norm, silu,
                                      torch_dtype)

__all__ = ["init_mamba", "mamba_block", "mamba_decode", "init_mamba_cache"]


def init_mamba(gen, cfg):
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = torch_dtype(cfg.dtype)
    dev = gen.device
    conv_ch = DI + 2 * N  # conv over (x, B, C) as in the reference impl
    return {
        # in_proj -> [z (DI), x (DI), B (N), C (N), dt (H)]
        "w_in": init_dense(gen, D, 2 * DI + 2 * N + H, dt),
        "conv_w": normal(gen, (cfg.conv_width, conv_ch), 0.2, dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=dev),
        "a_log": torch.zeros((H,), dtype=torch.float32, device=dev),   # A = -exp(a_log)
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((DI,), dtype=dt, device=dev),
        "w_out": init_dense(gen, DI, D, dt),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d.  x [B,S,C], w [K,C]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i : i + x.shape[1], :] * w[i]
    return out + b


def ssd_chunked(x, dt, A, B_ssm, C, chunk: int):
    """Chunked SSD scan.

    x [B,S,H,P], dt [B,S,H] (>0), A [H] (<0), B_ssm/C [B,S,N].
    Returns y [B,S,H,P] and the final state [B,H,P,N].
    """
    Bb, S, H, P = x.shape
    N = B_ssm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD chunk {Q}")
    nc = S // Q

    xc = x.reshape(Bb, nc, Q, H, P)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = B_ssm.reshape(Bb, nc, Q, N)
    Cc = C.reshape(Bb, nc, Q, N)

    dA = dtc * A  # [B,nc,Q,H] (negative)
    seg = torch.cumsum(dA, dim=2)                     # within-chunk cumulative log-decay
    total = seg[:, :, -1, :]                          # [B,nc,H]

    # --- intra-chunk (dual quadratic form) --------------------------------
    # L[q,s] = exp(seg[q] - seg[s]) for s <= q else 0
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]      # [B,nc,Q(q),Q(s),H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.where(causal[None, None, :, :, None], torch.exp(diff),
                    torch.zeros((), dtype=diff.dtype, device=x.device))
    cb = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)               # [B,nc,Q,Q]
    scores = cb[..., None] * L                                  # [B,nc,Q,Q,H]
    xdt = xc * dtc[..., None].to(x.dtype)                       # [B,nc,Q,H,P]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores.to(x.dtype), xdt)

    # --- chunk states + inter-chunk scan -----------------------------------
    decay_to_end = torch.exp(total[:, :, None, :] - seg)        # [B,nc,Q,H]
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn", Bc, (dtc * decay_to_end).to(x.dtype), xc)

    gammas = torch.exp(total)                                   # [B,nc,H]

    def combine(e1, e2):
        a1, s1 = e1
        a2, s2 = e2
        return a1 * a2, s1 * a2[..., None, None].to(s1.dtype) + s2

    _, s_scan = associative_scan(combine, (gammas, states), dim=1)   # [B,nc,H,P,N]
    # state *entering* chunk c = scanned state of chunk c-1 (zero for c=0)
    prev = torch.cat([torch.zeros_like(s_scan[:, :1]), s_scan[:, :-1]], dim=1)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev) * torch.exp(seg)[..., None].to(x.dtype)

    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    final = s_scan[:, -1]                                       # [B,H,P,N]
    return y, final


def _split_in(p, x, cfg):
    DI, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :DI]
    xbc = zxbcdt[..., DI : 2 * DI + 2 * N]
    dt_raw = zxbcdt[..., 2 * DI + 2 * N :]
    return z, xbc, dt_raw


def _softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba_block(p, x, cfg):
    """Full-sequence Mamba-2 mixer.  x [B,S,D] -> [B,S,D]."""
    B, S, D = x.shape
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _split_in(p, x, cfg)
    xbc = silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :DI].reshape(B, S, H, P)
    B_ssm = xbc[..., DI : DI + N]
    C = xbc[..., DI + N :]
    dt = _softplus(f32(dt_raw) + p["dt_bias"])                  # [B,S,H]
    A = -torch.exp(p["a_log"])

    y, _ = ssd_chunked(xs, dt, A, B_ssm, C, cfg.ssm_chunk)
    y = y + xs * p["d_skip"][None, None, :, None].to(x.dtype)
    y = y.reshape(B, S, DI)
    y = rms_norm(y * silu(z), p["out_norm"], cfg.norm_eps)
    return y @ p["w_out"]


def init_mamba_cache(cfg, batch, dtype, device=None):
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    conv_ch = DI + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=torch_dtype(dtype),
                            device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
    }


def mamba_decode(p, x, cfg, cache):
    """One-token recurrent update.  x [B,1,D]; the cache is updated in place."""
    B = x.shape[0]
    DI, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _split_in(p, x, cfg)

    # conv over (cached last K-1 inputs ++ current)
    window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)   # [B,K,C]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc1 = silu(conv_out)[:, None, :]

    xs = xbc1[..., :DI].reshape(B, H, P)
    B_ssm = xbc1[:, 0, DI : DI + N]
    C = xbc1[:, 0, DI + N :]
    dt = _softplus(f32(dt_raw[:, 0]) + p["dt_bias"])            # [B,H]
    A = -torch.exp(p["a_log"])

    gamma = torch.exp(dt * A)                                   # [B,H]
    upd = torch.einsum("bn,bh,bhp->bhpn", f32(B_ssm), dt, f32(xs))
    state = cache["state"] * gamma[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", f32(C), state).to(x.dtype)
    y = y + xs * p["d_skip"][None, :, None].to(x.dtype)
    y = y.reshape(B, 1, DI)
    y = rms_norm(y * silu(z), p["out_norm"], cfg.norm_eps)
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return y @ p["w_out"], cache
