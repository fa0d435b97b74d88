"""Collectives of the SPMD path: one process (rank) per PMV worker.

The port's counterpart of the ``lax`` collectives the JAX package calls
inline inside ``shard_map``.  Every placement keeps its leading worker axis:
in emulation (``axis=None``) it holds all b workers and each helper is the
leading-axis operation it always was (``all_to_all`` a transpose,
``all_gather`` the blocked vector itself, ``psum`` the identity); under a
:class:`WorkerAxis` it has length 1 on each rank, and the helpers move the
bytes between the ranks through ``torch.distributed``.

A rank owns the worker whose index is its row-major coordinate over the
``axis_name`` dims of a ``torch.distributed.device_mesh.DeviceMesh``: the
order ``shard_map`` gives, and the g = p * W + w of the two-hop exchange.

Every call here is collective over the axis: all of its ranks make it, in
the same order.  Nothing is caught: a failed collective raises on its rank.
"""
from __future__ import annotations

import dataclasses
import os

import torch

__all__ = ["WorkerAxis", "HierGroups", "worker_axis", "hier_groups", "rank_device",
           "axis_index", "all_gather", "all_to_all", "all_to_all_rows", "psum", "barrier"]


@dataclasses.dataclass(frozen=True)
class HierGroups:
    """The sub-groups of the two-hop exchange on a (pod, *inner) axis: this
    rank's pod group (the ranks that share its inner coordinates, one per
    pod) and its inner group (the W ranks of its pod)."""

    n_pods: int
    w_size: int
    pod: object
    inner: object


@dataclasses.dataclass(eq=False)
class WorkerAxis:
    """The worker axis of a mesh as this rank sees it: the axis dims, the
    process group over them, its size W (= b) and this rank's worker index."""

    names: tuple[str, ...]
    dims: tuple[int, ...]          # sizes of the axis dims, outermost first
    size: int
    index: int
    group: object                  # None: the default group
    ranks: tuple[int, ...]         # global rank of each worker, in worker order
    _hier: HierGroups | None = None


_AXES: dict = {}


def _names(axis_name) -> tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def worker_axis(mesh, axis_name="workers") -> WorkerAxis:
    """The :class:`WorkerAxis` of ``axis_name`` (a dim name, or a tuple of
    them) on ``mesh`` (a ``DeviceMesh`` with named dims), built once per
    (mesh, axis_name) and shared.  Collective on first use: every rank of the
    default group must build it, in the same order.  A mesh dim outside
    ``axis_name`` raises NotImplementedError naming it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh.DeviceMesh, "
                        f"got {type(mesh).__name__}")
    names = _names(axis_name)
    key = (id(mesh), names)
    hit = _AXES.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    dim_names = tuple(mesh.mesh_dim_names or ())
    for nm in names:
        if nm not in dim_names:
            raise ValueError(f"axis_name {nm!r} is not a dim of the mesh {dim_names}")
    for nm in dim_names:
        if nm not in names:
            raise NotImplementedError(
                f"mesh dim {nm!r} is outside axis_name {names}: the SPMD path runs one "
                "worker per rank over every dim of the mesh")
    grid = mesh.mesh.permute([dim_names.index(nm) for nm in names])
    ranks = tuple(int(r) for r in grid.flatten().tolist())
    if list(ranks) != sorted(ranks):
        raise NotImplementedError(
            f"axis_name {names} orders the workers {ranks}, not by ascending rank")
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not in the mesh {ranks}")
    group = None
    if list(ranks) != list(range(dist.get_world_size())):
        group = dist.new_group(list(ranks))
    axis = WorkerAxis(names=names, dims=tuple(int(s) for s in grid.shape), size=len(ranks),
                      index=ranks.index(me), group=group, ranks=ranks)
    _AXES[key] = (mesh, axis)
    return axis


def hier_groups(axis: WorkerAxis | None) -> HierGroups:
    """The two-hop exchange's sub-groups of a (pod, *inner) axis, built once
    (collective: every rank of the default group builds every sub-group, in
    the same order).  ValueError without a mesh or on a one-dim axis."""
    import torch.distributed as dist

    if axis is None or len(axis.names) < 2:
        raise ValueError("exchange='hier' needs a mesh and a tuple axis_name of at least two "
                         f"dims (pod, *inner), got {None if axis is None else axis.names}")
    if axis._hier is None:
        n_pods = axis.dims[0]
        w_size = axis.size // n_pods
        p, w = divmod(axis.index, w_size)
        pod = inner = None
        for ww in range(w_size):                     # one group per inner index
            g = dist.new_group([axis.ranks[pp * w_size + ww] for pp in range(n_pods)])
            if ww == w:
                pod = g
        for pp in range(n_pods):                     # one group per pod
            g = dist.new_group([axis.ranks[pp * w_size + ww] for ww in range(w_size)])
            if pp == p:
                inner = g
        axis._hier = HierGroups(n_pods=n_pods, w_size=w_size, pod=pod, inner=inner)
    return axis._hier


def rank_device(device) -> torch.device:
    """A rank's device: the CPU when asked, else ``cuda:{LOCAL_RANK %
    device_count()}`` (an explicit ``cuda:k`` is kept)."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def axis_index(axis: WorkerAxis | None) -> int:
    """This rank's worker index (0 in emulation, where the leading axis
    holds every worker from 0)."""
    return 0 if axis is None else axis.index


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as uint8 rows: the collectives only move
    bytes, and every backend takes uint8 (not every one takes bfloat16)."""
    if t.ndim == 0:
        t = t.reshape(1)
    return t.view(torch.uint8)


def all_gather(x: torch.Tensor, axis: WorkerAxis | None) -> torch.Tensor:
    """Per-worker [1, ...] -> [b, ...], worker j's row at j, on every
    worker.  Emulation: ``x`` itself, the blocked [b, ...] tensor every
    worker reads."""
    import torch.distributed as dist

    if axis is None:
        return x
    x = x.contiguous()
    out = torch.empty((axis.size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    # all_gather_into_tensor, under the name newer releases give it
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(_bytes(out), _bytes(x), group=axis.group)
    return out


def all_to_all_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Row j of ``x`` [k, ...] to group rank j; row j of the result from
    group rank j."""
    import torch.distributed as dist

    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(_bytes(out), _bytes(src), group=group)
    return out


def all_to_all(x: torch.Tensor, axis: WorkerAxis | None) -> torch.Tensor:
    """[b_sender, b_dest, ...] -> [b_dest, b_sender, ...]: emulation
    transposes the two leading axes; under an axis, x [1, b, ...] sends its
    row j to worker j and returns [1, b, ...] with row j from worker j."""
    if axis is None:
        return x.transpose(0, 1).contiguous()
    return all_to_all_rows(x[0], axis.group)[None]


def psum(x: torch.Tensor, axis: WorkerAxis | None) -> torch.Tensor:
    """Sum of a per-worker value over the axis (emulation: the value, which
    already covers every worker).  Integers are summed exactly in int64 and
    floats in float64, then cast back to x's dtype once: a count then takes
    the one rounding of its exact total that emulation's count takes."""
    import torch.distributed as dist

    if axis is None:
        return x
    y = x.to(torch.float64 if x.is_floating_point() else torch.int64).clone()
    dist.all_reduce(y, group=axis.group)
    return y.to(x.dtype)


def barrier(axis: WorkerAxis | None) -> None:
    """Wait for every worker of the axis (nothing in emulation)."""
    import torch.distributed as dist

    if axis is not None:
        dist.barrier(group=axis.group)
