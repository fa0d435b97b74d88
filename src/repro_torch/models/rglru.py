"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Recurrence: r_t = σ(W_r x_t), i_t = σ(W_i x_t),
            a_t = exp(-c · softplus(Λ) · r_t)          (c = 8)
            h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

A first-order linear recurrence with input-dependent decay, computed in
float32 by the JAX package's associative scan over time
(``layers.associative_scan``, log-depth); O(1) per step for decode.  The full recurrent block follows
Griffin: dual branches (conv1d -> RG-LRU) x (linear -> GeLU, the tanh form
``jax.nn.gelu`` takes by default), elementwise product, output projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import associative_scan, f32, init_dense, normal, torch_dtype
from repro_torch.models.ssm import _causal_conv, _softplus

__all__ = ["init_rglru_block", "rglru_block", "rglru_decode", "init_rglru_cache"]

_C = 8.0


def _lam_init(W: int, device) -> torch.Tensor:
    """Λ so that a lies in (0.9, 0.999) at r = 1 (Griffin §2.4):
    softplus(Λ) = -ln(a)/c  =>  Λ = ln(expm1(-ln(a)/c))."""
    a = torch.linspace(0.9, 0.999, W, dtype=torch.float32, device=device)
    return torch.log(torch.expm1(-torch.log(a) / _C))


def init_rglru_block(gen, cfg):
    D, W = cfg.d_model, cfg.lru_width
    dt = torch_dtype(cfg.dtype)
    return {
        "w_x": init_dense(gen, D, W, dt),           # recurrent branch in
        "w_gate_branch": init_dense(gen, D, W, dt),  # gelu branch
        "conv_w": normal(gen, (cfg.conv_width, W), 0.2, dt),
        "conv_b": torch.zeros((W,), dtype=dt, device=gen.device),
        "w_r": init_dense(gen, W, W, dt),
        "w_i": init_dense(gen, W, W, dt),
        "lam": _lam_init(W, gen.device),
        "w_out": init_dense(gen, W, D, dt),
    }


def _rglru_gates(p, xw):
    """xw [.., W] -> (a, gated_input) in f32."""
    r = torch.sigmoid(f32(xw @ p["w_r"]))
    i = torch.sigmoid(f32(xw @ p["w_i"]))
    log_a = -_C * _softplus(p["lam"]) * r                    # <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9))
    gated = beta * i * f32(xw)
    return a, gated


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def rglru_block(p, x, cfg):
    """Full-sequence recurrent block.  x [B,S,D] -> [B,S,D]."""
    xw = _causal_conv(x @ p["w_x"], p["conv_w"], p["conv_b"])
    a, gated = _rglru_gates(p, xw)

    def combine(e1, e2):
        a1, h1 = e1
        a2, h2 = e2
        return a1 * a2, h1 * a2 + h2

    _, h = associative_scan(combine, (a, gated), dim=1)
    branch = _gelu(f32(x @ p["w_gate_branch"]))
    y = (h * branch).to(x.dtype)
    return y @ p["w_out"]


def init_rglru_cache(cfg, batch, dtype, device=None):
    W = cfg.lru_width
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, W), dtype=torch_dtype(dtype),
                            device=device),
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
    }


def rglru_decode(p, x, cfg, cache):
    """One-step update.  x [B,1,D]; the cache is updated in place."""
    xw_in = x[:, 0] @ p["w_x"]                                 # [B,W]
    window = torch.cat([cache["conv"], xw_in[:, None].to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    a, gated = _rglru_gates(p, conv_out)
    h = cache["h"] * a + gated
    branch = _gelu(f32(x[:, 0] @ p["w_gate_branch"]))
    y = (h * branch).to(x.dtype)[:, None]
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return y @ p["w_out"], cache

