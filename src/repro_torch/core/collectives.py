"""Collectives of the SPMD path: one process (rank) per PMV worker.

The port's counterpart of the ``lax`` collectives the JAX package calls
inline inside ``shard_map``.  Every placement keeps its leading worker axis:
in emulation (``axis=None``) it holds all b workers and each helper is the
leading-axis operation it always was (``all_to_all`` a transpose,
``all_gather`` the blocked vector itself, ``psum`` the identity); under a
:class:`WorkerAxis` it holds the rank's own workers, and the helpers move the
bytes between the ranks through ``torch.distributed``.  The resident path
runs one worker a rank (W = b, a leading axis of length 1); the out-of-core
path lets each rank own a contiguous range of b_w = b / W workers (rank w
holds workers [w * b_w, (w + 1) * b_w), the stripe files of its
``Manifest.worker_shard_view(w, W)``), and ``all_gather`` / ``all_to_all``
take any b_w.

A rank owns the worker whose index is its row-major coordinate over the
``axis_name`` dims of a ``torch.distributed.device_mesh.DeviceMesh``: the
order ``shard_map`` gives, and the g = p * W + w of the two-hop exchange.
``axis_name`` may list the dims in any order, and a mesh may place its
ranks in any order: the worker index is the position in that row-major
order, whatever the ranks' own order.  ``torch.distributed`` orders a
group's members by global rank, so where the two differ the helpers permute
the chunks of ``all_to_all_single`` and the rows of
``all_gather_into_tensor`` (``WorkerAxis.order``).  The mesh dims outside
``axis_name`` are replicas, as ``shard_map`` over ``P(axis_name)`` makes
them: every combination of their coordinates holds its own b workers, over
its own process group, and runs the same solve (``WorkerAxis.replica``).

Every call here is collective over the axis: all of its ranks make it, in
the same order.  Nothing is caught: a failed collective raises on its rank.
"""
from __future__ import annotations

import dataclasses
import math
import os

import torch

__all__ = ["WorkerAxis", "HierGroups", "worker_axis", "hier_groups", "rank_device",
           "is_lead", "axis_index", "own_slice", "all_gather", "all_gather_object", "all_to_all",
           "all_to_all_rows", "psum", "barrier"]


@dataclasses.dataclass(frozen=True)
class HierGroups:
    """The sub-groups of the two-hop exchange on a (pod, *inner) axis: this
    rank's pod group (the ranks that share its inner coordinates, one per
    pod) and its inner group (the W ranks of its pod), each with the member
    index of every group rank (``pod_order`` / ``inner_order``, None where it
    is the group's own rank order)."""

    n_pods: int
    w_size: int
    pod: object
    inner: object
    pod_order: tuple[int, ...] | None = None
    inner_order: tuple[int, ...] | None = None


@dataclasses.dataclass(eq=False)
class WorkerAxis:
    """The worker axis of a mesh as this rank sees it: the axis dims, the
    process group over this rank's replica of them, its size W (= b) and
    this rank's worker index.  ``order[g]`` is the worker index of the
    group's rank g (None where they agree); ``replica`` is the row-major
    index of this rank's coordinates over the mesh dims outside the axis (0
    without such dims), ``mesh_group`` the group over every rank of the mesh
    (None: the default group)."""

    names: tuple[str, ...]
    dims: tuple[int, ...]          # sizes of the axis dims, outermost first
    size: int
    index: int
    group: object                  # None: the default group
    replicas: tuple[tuple[int, ...], ...]   # every replica's global ranks, in worker order
    replica: int = 0
    order: tuple[int, ...] | None = None
    mesh_group: object = None
    _hier: HierGroups | None = None

    @property
    def ranks(self) -> tuple[int, ...]:
        """The global rank of each worker of this rank's replica, in worker
        order."""
        return self.replicas[self.replica]


_AXES: dict = {}


def _names(axis_name) -> tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def _group(members) -> tuple[object, tuple[int, ...] | None]:
    """A process group over the global ranks ``members`` (None: the default
    group, when they are every rank in rank order) and the member index of
    each of its group ranks (None where that is the identity).  Collective
    over the default group: every rank calls it, for every group, in the
    same order; the order is read only on a member."""
    import torch.distributed as dist

    members = [int(r) for r in members]
    if members == list(range(dist.get_world_size())):
        return None, None
    group = dist.new_group(sorted(members))
    if dist.get_rank() not in members:
        return group, None
    order = tuple(members.index(r) for r in dist.get_process_group_ranks(group))
    return group, (None if order == tuple(range(len(members))) else order)


def worker_axis(mesh, axis_name="workers") -> WorkerAxis:
    """The :class:`WorkerAxis` of ``axis_name`` (a dim name, or a tuple of
    them, in any order) on ``mesh`` (a ``DeviceMesh`` with named dims), built
    once per (mesh, axis_name) and shared.  A mesh dim outside ``axis_name``
    makes replicas (module doc): one group over each replica's ranks, all
    built on every rank.  Collective on first use: every rank of the
    default group must build it, in the same order."""
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
    outside = [d for d, nm in enumerate(dim_names) if nm not in names]
    grid = mesh.mesh.permute(outside + [dim_names.index(nm) for nm in names])
    dims = tuple(int(s) for s in grid.shape[len(outside):])
    size = math.prod(dims)
    replicas = tuple(tuple(int(r) for r in row) for row in grid.reshape(-1, size).tolist())
    me = dist.get_rank()
    mine = [k for k, ranks in enumerate(replicas) if me in ranks]
    if not mine:
        raise ValueError(f"rank {me} is not in the mesh {replicas}")
    groups = [_group(ranks) for ranks in replicas]      # every replica's, on every rank
    k = mine[0]
    mesh_group = groups[k][0]                           # one replica: the mesh is the axis
    if len(replicas) > 1:
        mesh_group = _group(sorted(r for ranks in replicas for r in ranks))[0]
    axis = WorkerAxis(names=names, dims=dims, size=size, index=replicas[k].index(me),
                      group=groups[k][0], replicas=replicas, replica=k, order=groups[k][1],
                      mesh_group=mesh_group)
    _AXES[key] = (mesh, axis)
    return axis


def hier_groups(axis: WorkerAxis | None) -> HierGroups:
    """The two-hop exchange's sub-groups of a (pod, *inner) axis, built once
    (collective: every rank of the default group builds every sub-group of
    every replica, in the same order).  ValueError without a mesh or on a
    one-dim axis."""
    if axis is None or len(axis.names) < 2:
        raise ValueError("exchange='hier' needs a mesh and a tuple axis_name of at least two "
                         f"dims (pod, *inner), got {None if axis is None else axis.names}")
    if axis._hier is None:
        n_pods = axis.dims[0]
        w_size = axis.size // n_pods
        p, w = divmod(axis.index, w_size)
        pod = inner = pod_order = inner_order = None
        for k, ranks in enumerate(axis.replicas):
            for ww in range(w_size):                     # one group per inner index
                g, order = _group([ranks[pp * w_size + ww] for pp in range(n_pods)])
                if k == axis.replica and ww == w:
                    pod, pod_order = g, order
            for pp in range(n_pods):                     # one group per pod
                g, order = _group([ranks[pp * w_size + ww] for ww in range(w_size)])
                if k == axis.replica and pp == p:
                    inner, inner_order = g, order
        axis._hier = HierGroups(n_pods=n_pods, w_size=w_size, pod=pod, inner=inner,
                                pod_order=pod_order, inner_order=inner_order)
    return axis._hier


def rank_device(device) -> torch.device:
    """A rank's device: the CPU when asked, else ``cuda:{LOCAL_RANK %
    device_count()}`` (an explicit ``cuda:k`` is kept)."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def is_lead(axis: WorkerAxis | None) -> bool:
    """True on the one rank that writes what the whole mesh shares (a
    checkpoint): worker 0 of replica 0 (always in emulation)."""
    return axis is None or (axis.index == 0 and axis.replica == 0)


def axis_index(axis: WorkerAxis | None) -> int:
    """This rank's worker index (0 in emulation, where the leading axis
    holds every worker from 0)."""
    return 0 if axis is None else axis.index


def own_slice(axis: WorkerAxis | None, b: int) -> slice:
    """The rows of a per-worker [b, ...] array this rank holds: every row in
    emulation, rank w's contiguous [w * b_w, (w + 1) * b_w) under an axis
    (b_w = b / W)."""
    if axis is None:
        return slice(None)
    b_w = b // axis.size
    return slice(axis.index * b_w, (axis.index + 1) * b_w)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as uint8 rows: the collectives only move
    bytes, and every backend takes uint8 (not every one takes bfloat16)."""
    if t.ndim == 0:
        t = t.reshape(1)
    return t.view(torch.uint8)


def _to_group_order(x: torch.Tensor, order) -> torch.Tensor:
    """Rows [k, ...] from member order into group-rank order (``order[g]``:
    the member index of group rank g)."""
    if order is None:
        return x
    return x.index_select(0, torch.tensor(order, device=x.device))


def _from_group_order(x: torch.Tensor, order) -> torch.Tensor:
    """Rows [k, ...] from group-rank order back into member order."""
    if order is None:
        return x
    inv = [0] * len(order)
    for g, m in enumerate(order):
        inv[m] = g
    return x.index_select(0, torch.tensor(inv, device=x.device))


def all_gather(x: torch.Tensor, axis: WorkerAxis | None) -> torch.Tensor:
    """A rank's workers' rows [b_w, ...] -> [b, ...] (b = W * b_w), worker
    j's row at j, on every rank.  Emulation: ``x`` itself, the blocked
    [b, ...] tensor every worker reads."""
    import torch.distributed as dist

    if axis is None:
        return x
    x = x.contiguous()
    out = torch.empty((axis.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    # all_gather_into_tensor, under the name newer releases give it
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(_bytes(out), _bytes(x), group=axis.group)
    if axis.order is None:
        return out
    return _from_group_order(out.reshape((axis.size, -1) + tuple(x.shape[1:])),
                             axis.order).reshape(out.shape)


def all_gather_object(obj, axis: WorkerAxis | None) -> list:
    """Every worker's picklable ``obj``, in worker order (emulation: [obj])."""
    import torch.distributed as dist

    if axis is None:
        return [obj]
    got = [None] * axis.size
    dist.all_gather_object(got, obj, group=axis.group)
    if axis.order is None:
        return got
    out = [None] * axis.size
    for g, m in enumerate(axis.order):
        out[m] = got[g]
    return out


def all_to_all_rows(x: torch.Tensor, group, order=None) -> torch.Tensor:
    """Row j of ``x`` [k, ...] to the group's member j; row j of the result
    from member j.  ``order`` (the member index of each group rank, as
    :func:`worker_axis` and :func:`hier_groups` keep it) None: the members
    are the group's ranks in order."""
    import torch.distributed as dist

    src = _to_group_order(x, order).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(_bytes(out), _bytes(src), group=group)
    return _from_group_order(out, order)


def all_to_all(x: torch.Tensor, axis: WorkerAxis | None) -> torch.Tensor:
    """[b_sender, b_dest, ...] -> [b_dest, b_sender, ...]: emulation
    transposes the two leading axes.  Under an axis a rank holds its senders'
    rows x [b_w, b, ...] and gets back its destinations' rows [b_w, b, ...]
    (every sender in worker order), the rows of the emulated transpose it
    owns: x[:, j] goes to destination j's rank.  One ``all_to_all_single``
    carries the [b_w, b_w, ...] chunk of each pair of ranks; at b_w = 1
    that is x[0]'s row j to rank j."""
    if axis is None:
        return x.transpose(0, 1).contiguous()
    b_w, rest = x.shape[0], tuple(x.shape[2:])
    # [b_w(s), W, b_w(d), ...] -> [W, b_w(s), b_w(d), ...]: rank r's chunk contiguous
    send = x.reshape((b_w, axis.size, b_w) + rest).transpose(0, 1)
    got = all_to_all_rows(send, axis.group, axis.order)   # [W (sending worker), ...]
    return got.permute((2, 0, 1) + tuple(range(3, got.ndim))).reshape(
        (b_w, axis.size * b_w) + rest)


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
    """Wait for every rank of the mesh, every replica's workers (nothing in
    emulation)."""
    import torch.distributed as dist

    if axis is not None:
        dist.barrier(group=axis.mesh_group)
