"""AdamW with decoupled weight decay, global-norm clipping, and a
warmup+cosine schedule (the JAX package's ``repro.training.optimizer``).

Parameters, gradients and the moments are dicts of tensors under the same
names (``Model.params()``'s).  Moments are float32; a bfloat16 parameter is
updated in float32 and cast back (master-copy semantics).  The scalars the
JAX package computes in float32 (the schedule, the bias corrections, the
clip scale) are float32 tensors here too, so every update rounds as its
does.  ``adamw_update`` writes the parameters and the moments in place (the
JAX package's train CLI donates them) and returns them.  On a device mesh
the parameters, gradients and moments are DTensors under the parameters'
placements and each rank updates its local shards.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import spmd as spmd_lib

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a float32 scalar."""
    step = _f32(step, step.device if isinstance(step, torch.Tensor) else None)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    # (1 - min_lr_ratio) * 0.5 folds in float64 first, as the JAX expression does
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _zeros32(p) -> torch.Tensor:
    """float32 zeros of p's shape; a DTensor's under its placements."""
    if _is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _local(x):
    return x.to_local() if _is_dtensor(x) else x


def adamw_init(params: dict) -> dict:
    """Zero moments (DTensors under their parameters' placements on a mesh)."""
    first = next(iter(params.values()), None)
    return {
        "mu": {k: _zeros32(p) for k, p in params.items()},
        "nu": {k: _zeros32(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32,
                            device=None if first is None else _local(first).device),
    }


def _leaf_key(name: str) -> tuple:
    """A name's place in ``jax.tree.leaves`` order of the JAX package's tree:
    dict keys sort as strings, list indices as numbers, and a stacked
    layer ('blocks.3.l0.attn.wq') belongs to its stack's leaf."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks", "dec_blocks") and len(parts) > 2:
        parts = [parts[0]] + parts[2:]
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in parts)


def _squares(grads: dict) -> dict:
    """Each gradient's sum of squares, in float32.  A DTensor's local sums
    are summed over the mesh dims that shard it, one all-reduce for all the
    gradients of one placement."""
    out, by_pl = {}, {}
    for name, g in grads.items():
        s = torch.sum(torch.square(_local(g).to(torch.float32)))
        if _is_dtensor(g):
            by_pl.setdefault((g.device_mesh, tuple(g.placements)), []).append((name, s))
        else:
            out[name] = s
    if by_pl:
        import torch.distributed as dist
        from torch.distributed.tensor import Shard

        for (mesh, pls), items in by_pl.items():
            total = torch.stack([s for _, s in items])
            for a, pl in zip(mesh.mesh_dim_names, pls):
                if isinstance(pl, Shard) and spmd_lib.dim_size(mesh, a) > 1:
                    dist.all_reduce(total, group=mesh.get_group(a))
            out.update((name, total[i]) for i, (name, _) in enumerate(items))
    return out


def _global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of squares, summed leaf by leaf in the JAX package's
    leaf order (a stacked leaf's layers first summed together); a sharded
    gradient's sum is its full tensor's."""
    total = None
    groups: dict = {}
    for name in grads:
        groups.setdefault(_leaf_key(name), []).append(name)
    squares = _squares(grads)
    for key in sorted(groups):
        leaf = None
        for name in groups[key]:
            s = squares[name]
            leaf = s if leaf is None else leaf + s
        total = leaf if total is None else total + leaf
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: dict, grads: dict, state: dict):
    """Returns (params, state, metrics); params and the moments are written
    in place.  On a mesh every rank updates its own shards: each gradient
    must arrive under its parameter's placements (the mesh step's
    ``spmd`` backward reduces it so); any other placement, ``Partial``
    included, raises."""
    for k, g in grads.items():
        if _is_dtensor(g) and tuple(g.placements) != tuple(params[k].placements):
            raise ValueError(f"gradient {k!r} has placements {tuple(g.placements)}, its "
                             f"parameter {tuple(params[k].placements)}: reduce it to the "
                             "parameter's placements first")
    gnorm = _global_norm(grads)
    one = torch.ones((), dtype=torch.float32, device=gnorm.device)
    scale = torch.minimum(one, torch.full_like(one, cfg.clip_norm)
                          / torch.clamp(gnorm, min=1e-9))
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.b1, step.device), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, step.device), stepf)

    for name, p in params.items():
        p = _local(p)
        mu, nu = _local(state["mu"][name]), _local(state["nu"][name])
        g = _local(grads[name]).to(torch.float32) * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = mu / b1c
        vhat = nu / b2c
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
