"""GPipe-style pipeline parallelism over the 'pod' axis (the JAX package's
``repro.training.pipeline``, on a torch DeviceMesh).

The multi-pod mesh's pod axis defaults to cross-pod DP; this module provides
the alternative: each pod holds a contiguous stage of layers and
microbatches flow around a ring of the axis' ranks -- inter-pod traffic
becomes one activation tensor per microbatch-step instead of gradient
all-reduces, the right trade when layers/pod are deep and the DCI is thin.

``pipeline_apply`` is the schedule core: M + S - 1 steps, stage 0 injecting
microbatch min(t, M - 1), the last stage recording slot t - (S - 1), the
activations shifted one stage along the ring each step.  The shift is a
``torch.autograd.Function`` (``dist.batch_isend_irecv`` on the axis'
process group: forward sends to the next stage and receives from the
previous one, backward the reverse), so autograd through the schedule
gives the standard GPipe backward with bubble 2(S-1)/(M+S-1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import spmd as spmd_lib

__all__ = ["pipeline_apply"]


def _axis_ranks(mesh, axis: str) -> list[int]:
    """Global ranks of this rank's ring along ``axis``, in stage order."""
    coord = list(mesh.get_coordinate())
    dim = mesh.mesh_dim_names.index(axis)
    ranks = []
    for s in range(mesh.shape[dim]):
        coord[dim] = s
        ranks.append(int(mesh.mesh[tuple(coord)]))
    return ranks


def _shift(x: torch.Tensor, send_to: int, recv_from: int, group) -> torch.Tensor:
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class RingShift(torch.autograd.Function):
    """y on stage s -> stage s + 1 (mod S); the gradient flows back."""

    @staticmethod
    def forward(ctx, x, nxt: int, prv: int, group):
        ctx.nxt, ctx.prv, ctx.group = nxt, prv, group
        return _shift(x, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


class AxisSum(torch.autograd.Function):
    """psum over the axis of a value whose consumers are the same on every
    rank of it: all-reduce forward, the gradient passed through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _stage_slice(a, stage: int, mesh, axis: str):
    """This stage's [...] of a tree leaf stacked on [n_stages]: a DTensor
    sharded over ``axis`` on dim 0 is its local [1, ...]; a full tensor is
    indexed (its gradient then lands on this stage's slice only)."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(a, DTensor):
        dim = mesh.mesh_dim_names.index(axis)
        if a.placements[dim] != Shard(0):
            raise ValueError(f"stage params must be sharded over {axis!r} on dim 0; "
                             f"got {a.placements}")
        others = [i for i in range(mesh.ndim) if i != dim]
        if any(isinstance(a.placements[i], Shard) for i in others):
            raise ValueError("stage params are split over the pipeline axis only")
        return a.to_local()[0]
    return a[stage]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn, stage_params, microbatches, mesh, *, axis: str = "pod"):
    """Run ``n_stages`` sequential stages over M microbatches on a ring.

    stage_fn: (params_one_stage, x) -> y (same shape as x).
    stage_params: tree stacked on a leading [n_stages] axis: DTensors
        sharded over ``axis`` on dim 0 (each rank holds its stage's slice;
        their gradients are the stacked gradients), or full tensors (each
        rank reads its stage's slice; the stacked gradient is the sum of the
        ranks' over the axis).
    microbatches: [M, ...] (replicated across the pipeline axis).
    Returns [M, ...] outputs of the final stage, on every rank of the axis.
    """
    n_stages = spmd_lib.dim_size(mesh, axis)
    M = microbatches.shape[0]
    steps = M + n_stages - 1
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    ring = _axis_ranks(mesh, axis)
    nxt, prv = ring[(stage + 1) % n_stages], ring[(stage - 1) % n_stages]
    p = _tree_map(lambda a: _stage_slice(a, stage, mesh, axis), stage_params)

    inflight = torch.zeros_like(microbatches[0])
    first = torch.tensor(stage == 0, device=microbatches.device)
    last = torch.tensor(stage == n_stages - 1, device=microbatches.device)
    outputs = [torch.zeros_like(microbatches[0]) for _ in range(M)]
    for t in range(steps):
        # stage 0 injects microbatch t (while available); the others take
        # what the previous stage sent last step.  A select, as in the JAX
        # package, keeps every received tensor in every rank's graph, so
        # each rank's backward runs the same ring shifts in the same order.
        x = torch.where(first, microbatches[min(t, M - 1)], inflight)
        y = stage_fn(p, x)
        out_slot = t - (n_stages - 1)
        if out_slot >= 0:       # the last stage records (a select on every stage)
            outputs[out_slot] = torch.where(last, y, outputs[out_slot])
        inflight = RingShift.apply(y, nxt, prv, group)
    # only the last stage holds results (zeros elsewhere): the psum makes
    # the output the same on every rank of the axis
    return AxisSum.apply(torch.stack(outputs), group)
