"""Mixture-of-Experts FFN with capacity-factor dispatch (GShard-style).

Token->expert routing is a sparse generalized matvec: per expert, take the
first C assigned slots via top-k on a "first-valid" score, then gather and
scatter (``index_add_``).  Overflowing tokens are dropped (standard
capacity-factor semantics).  The routing equals the JAX package's exactly:
the valid slots' scores are distinct, so ``torch.topk`` orders them as
``lax.top_k`` does, and ties among the invalid ones are masked out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import spmd
from repro_torch.models.layers import f32, init_dense, normal, silu, swiglu, torch_dtype

__all__ = ["init_moe", "moe_ffn"]


def init_moe(gen, cfg):
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg.dtype)
    scale_in, scale_out = D ** -0.5, F_ ** -0.5
    p = {
        "router": init_dense(gen, D, E, torch.float32),  # router in f32
        "w_gate": normal(gen, (E, D, F_), scale_in, dt),
        "w_up": normal(gen, (E, D, F_), scale_in, dt),
        "w_down": normal(gen, (E, F_, D), scale_out, dt),
    }
    if cfg.n_shared_experts:
        Fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": init_dense(gen, D, Fs, dt),
            "w_up": init_dense(gen, D, Fs, dt),
            "w_down": init_dense(gen, Fs, D, dt),
        }
    return p


def _dispatch_indices(expert_ids, n_experts, capacity):
    """expert_ids [T, k] -> (token_slot [E, C] int64 into flat T*k, valid [E, C]).

    First-come-first-served within each expert, matching GShard capacity
    semantics; relies only on top-k + comparisons (no sort of the full table).
    """
    Tk = expert_ids.shape[0] * expert_ids.shape[1]
    flat = expert_ids.reshape(-1)                      # [T*k]
    arange = torch.arange(Tk, device=flat.device)
    experts = torch.arange(n_experts, device=flat.device)
    # score[e, s] > 0 iff slot s routed to e; earlier slots score higher.
    score = torch.where(flat[None, :] == experts[:, None], Tk - arange[None, :],
                        torch.zeros((), dtype=arange.dtype, device=flat.device))
    top_score, top_idx = torch.topk(score, capacity, dim=-1)  # [E, C]
    valid = top_score > 0
    return torch.where(valid, top_idx, torch.full_like(top_idx, Tk)), valid


def moe_ffn(p, x, cfg, *, return_aux=False, no_drop=False):
    """x [B, S, D] -> [B, S, D].  Routed top-k experts + optional shared.

    no_drop=True (decode/inference): capacity = T*k, no token ever dropped.
    Training uses the GShard capacity factor (drops on overflow).

    On a mesh (``repro_torch.models.spmd``) the dispatch is global, as the
    JAX package's: the tokens are gathered over the ranks holding different
    ones, every rank routes them all and computes its contiguous share of
    the (expert, slot) pairs, and a reduce-scatter returns each rank's
    tokens (the shared experts are token-local).  Under tensor parallelism
    the share is split over the row dims only: each 'model' rank computes
    its pairs on its ``moe_d_ff`` columns of every expert (the experts'
    'model' shards), the tokens and the gates entering by "copy in" and the
    sum leaving by "reduce out"; the router stays replicated over 'model'.
    Without dropping (no_drop) a token's routing does not depend on the
    others: each rank routes its own.  Off a mesh, and under no_drop, one
    rank holds every token and every pair (``spmd.ONE_RANK``: the gather,
    the share and the reduce-scatter are identities).
    """
    ctx = spmd.active()
    if no_drop:
        ctx = spmd.ONE_RANK
    tp = ctx.tp_on("moe")
    # each rank's router logits, gathered with the tokens (the router is
    # token-local; its logits are E wide, the tokens D)
    logits = ctx.gather_tokens(f32(x) @ p["router"])
    xg = ctx.gather_tokens(ctx.copy_in(x) if tp else x)
    out, aux = _routed(p, xg, logits, cfg, no_drop=no_drop, ctx=ctx, tp=tp)
    out = ctx.scatter_tokens(out)
    if tp:
        out = ctx.reduce_out(out)
    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], x, layer="moe")
    return (out, aux) if return_aux else out


def _routed(p, x, logits, cfg, *, no_drop, ctx, tp):
    """The routed experts' sum [B, S, D] and the aux loss of tokens ``x``
    [B, S, D] routed by ``logits`` [B, S, E], over this rank's (expert,
    slot) pairs: ``ctx.share(n)`` gives its [lo, hi) of the n = E * C pairs
    in expert-major order (all of them on one rank); ``tp``: each pair on
    this rank's 'model' shard of the experts' columns, its partial sum."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)

    probs = torch.softmax(logits.reshape(T, E), dim=-1)
    gate, eid = torch.topk(probs, k, dim=-1)           # [T, k]
    gate = gate / torch.clamp(torch.sum(gate, dim=-1, keepdim=True), min=1e-9)  # renorm

    if no_drop:
        capacity = T * k
    else:
        capacity = int(T * k / E * cfg.capacity_factor) or 1
        capacity = min(capacity, T * k)
    slot_tok, valid = _dispatch_indices(eid, E, capacity)   # [E, C] into T*k
    tok_idx = torch.clamp(slot_tok // k, 0, T - 1)          # token of each slot
    gate_ec = torch.where(valid, gate.reshape(-1)[torch.clamp(slot_tok, 0, T * k - 1)],
                          torch.zeros((), dtype=gate.dtype, device=x.device))

    # the experts holding this rank's pairs; a pair outside the share
    # computes zeros (masked like an invalid slot)
    lo, hi = ctx.share(E * capacity, tp=tp)
    e0, e1 = lo // capacity, -(-hi // capacity)
    pair = torch.arange(e0 * capacity, e1 * capacity, device=x.device).reshape(-1, capacity)
    mine = valid[e0:e1] & (pair >= lo) & (pair < hi)
    tok_idx, gate_ec = tok_idx[e0:e1], gate_ec[e0:e1]

    w = p.shard if tp else p.__getitem__
    if tp:      # the router's gates enter the experts' TP region
        gate_ec = ctx.copy_in(gate_ec)
    x_e = xt[tok_idx] * mine[..., None].to(xt.dtype)       # [E', C, D]
    h = silu(torch.einsum("ecd,edf->ecf", x_e, w("w_gate")[e0:e1])) * torch.einsum(
        "ecd,edf->ecf", x_e, w("w_up")[e0:e1])
    y_e = torch.einsum("ecf,efd->ecd", h, w("w_down")[e0:e1])      # [E', C, D]
    y_e = y_e * gate_ec[..., None].to(y_e.dtype)
    # one index_add_ an expert, in expert order: a token's k contributions
    # land one at a time, in the order of the JAX package's scatter-add (its
    # slot rows are expert-major), so a bfloat16 sum rounds as that one does
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for e in range(e1 - e0):
        out.index_add_(0, tok_idx[e], y_e[e].to(x.dtype))

    out = out.reshape(B, S, D)
    # GShard load-balancing aux loss.
    density = torch.mean(F.one_hot(eid[:, 0], E).to(torch.float32), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux = torch.sum(density * mean_prob) * E
    return out, aux
