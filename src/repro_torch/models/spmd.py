"""The mesh context of a sharded model: DTensor parameters, local compute.

``Model.distribute(mesh)`` turns every parameter into a DTensor placed by
``repro_torch.models.sharding.param_shardings`` (the JAX package's 2D rule:
TP dim over 'model', FSDP dim over 'data', replicated over 'pod').  A call
of the model under a mesh then runs in PyTorch's FSDP idiom:

- the batch's rows stay where ``batch_shardings`` put them: each rank
  computes on its own rows (the mesh dims that split dim 0 of the batch);
- each parameter is gathered whole where a layer reads it (its local
  shard all-gathered over the mesh dims that shard it) and its gradient
  comes back reduced to the parameter's own placements: reduce-scattered
  over the dims that shard it and all-reduced over the others, wherever
  that dim's ranks computed on other tokens (the local gradient is
  ``Partial`` over them);
- with ``cfg.seq_parallel`` the residual stream's sequence dim is also
  split over 'model' (each rank its S / model positions): token-local
  layers run on the slice, attention gathers K and V over 'model'
  (``_replicated_constraint``), and the blocks that are not token-local
  (the SSD scan, the RG-LRU recurrence, MLA) run on the gathered sequence
  and keep their slice;
- the MoE FFN's dispatch is global, as the JAX package's is: the tokens are
  gathered over the ranks that hold different ones, every rank routes them
  all and computes its contiguous share of the (expert, slot) pairs, and a
  reduce-scatter returns each rank's tokens;
- the loss is each rank's share of the global mean, summed over the ranks
  (``sum_partial``: its gradient is 1 on every rank).

Without ``seq_parallel`` the 'model' ranks split each rank's rows further
where they divide (``model_rows``: data parallelism over the whole mesh; a
decode step, whose caches split over 'model', keeps them whole), else
compute the same rows (no tensor parallelism); a mesh dim listed in ``manual`` (the pod axis under
``compress_pod``) runs independent steps, its gradients left unreduced for
the caller.  Every cross-rank step is a ``torch.autograd.Function`` over
``torch.distributed``'s collectives on the process group of each mesh dim
(``DeviceMesh.get_group``): all-gather, reduce-scatter and all-reduce of
the tensors where they are, so nothing moves off the device and a
collective the backend lacks raises under its own name.

Off a mesh the model runs in ``ONE_RANK``, the context of one rank that
holds every row, position and MoE (expert, slot) pair: each method is the
identity there, so the model's code has one path.  (DTensor's own
``redistribute`` runs the functional collectives, which crash a gloo group
holding CUDA tensors in torch 2.11; the c10d ones take them.)
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

__all__ = ["Spmd", "ONE_RANK", "active", "local_param", "batch_rows", "full_tensor"]


def active():
    """The Spmd of the model call in progress; ``ONE_RANK`` outside a mesh
    call."""
    return _ACTIVE.get()


def dim_size(mesh, name: str) -> int:
    """The size of ``mesh``'s dim ``name``, read off its shape (``mesh[name]``
    builds a sub-mesh: tensor ops on the rank grid at every call)."""
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def batch_rows(leaf, mesh) -> tuple:
    """The mesh dims that split dim 0 of a batch DTensor, in mesh order."""
    from torch.distributed.tensor import Shard

    if not _is_dtensor(leaf):
        return ()
    return tuple(a for a, pl in zip(mesh.mesh_dim_names, leaf.placements)
                 if isinstance(pl, Shard) and pl.dim == 0)


def _all_gather(x, dim: int, group, n: int):
    """Concatenate the group's ``x`` along ``dim`` (in group-rank order)."""
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, dim: int, group, n: int):
    """Sum the group's ``x`` and keep this rank's 1/n along ``dim``."""
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, group, n: int, op=dist.ReduceOp.SUM):
    if n == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _Gather(torch.autograd.Function):
    """All-gather along ``plan``'s (tensor dim, mesh dim) steps in order;
    the gradient is reduce-scattered back in reverse."""

    @staticmethod
    def forward(ctx, x, mesh, plan):
        ctx.mesh, ctx.plan = mesh, plan
        for d, a in plan:
            x = _all_gather(x, d, mesh.get_group(a), dim_size(mesh, a))
        return x

    @staticmethod
    def backward(ctx, g):
        for d, a in reversed(ctx.plan):
            g = _reduce_scatter(g, d, ctx.mesh.get_group(a), dim_size(ctx.mesh, a))
        return g, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``plan`` in reverse (the sum of every rank's
    partial tensor, split); the gradient is all-gathered."""

    @staticmethod
    def forward(ctx, x, mesh, plan):
        ctx.mesh, ctx.plan = mesh, plan
        for d, a in reversed(plan):
            x = _reduce_scatter(x, d, mesh.get_group(a), dim_size(mesh, a))
        return x

    @staticmethod
    def backward(ctx, g):
        for d, a in ctx.plan:
            g = _all_gather(g, d, ctx.mesh.get_group(a), dim_size(ctx.mesh, a))
        return g, None, None


class _SumPartial(torch.autograd.Function):
    """All-reduce over mesh dims of a value every rank then differentiates
    the same way: the gradient of each share is the sum's."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        for a in dims:
            x = _all_reduce(x, mesh.get_group(a), dim_size(mesh, a))
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ParamGather(torch.autograd.Function):
    """A parameter's local shard -> the whole tensor.  Backward: the local
    gradient (Partial over ``partial``) reduce-scattered over each mesh dim
    that shards it (or, where that dim's ranks computed the same tokens,
    just cut to this rank's slice) and all-reduced over each replicating
    dim in ``partial``."""

    @staticmethod
    def forward(ctx, x, mesh, shards, partial):
        ctx.mesh, ctx.shards, ctx.partial = mesh, shards, partial
        for d, a in reversed(shards):          # minor mesh dim first
            x = _all_gather(x, d, mesh.get_group(a), dim_size(mesh, a))
        return x

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        sharded = {a for _, a in ctx.shards}
        for d, a in ctx.shards:                # major mesh dim first
            n = dim_size(mesh, a)
            if a in ctx.partial:
                g = _reduce_scatter(g, d, mesh.get_group(a), n)
            else:
                k = g.shape[d] // n
                g = g.narrow(d, mesh.get_local_rank(a) * k, k)
        for a in ctx.partial:
            if a not in sharded:
                g = _all_reduce(g, mesh.get_group(a), dim_size(mesh, a))
        return g.contiguous(), None, None, None


def full_tensor(t):
    """A DTensor gathered whole on every rank (Shard / Replicate placements)
    with the c10d collectives; anything else as it is."""
    if not _is_dtensor(t):
        return t
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    shards = tuple((pl.dim, a) for a, pl in zip(mesh.mesh_dim_names, t.placements)
                   if isinstance(pl, Shard))
    with torch.no_grad():
        return _ParamGather.apply(t.to_local(), mesh, shards, ())


class Spmd:
    """One call's layout on ``mesh``: ``rows`` the mesh dims splitting the
    batch rows, ``seq`` whether 'model' splits the sequence, ``manual``
    mesh dims whose ranks run independent steps.  ``mesh=None`` is one rank
    holding every row, position and (expert, slot) pair (``ONE_RANK``, the
    model off a mesh): every method is then the identity."""

    def __init__(self, mesh, *, rows: tuple = (), seq: bool = False, manual: tuple = (),
                 model_rows: bool = False):
        names = () if mesh is None else mesh.mesh_dim_names
        if seq and mesh is not None and "model" not in names:
            raise ValueError(f"seq_parallel needs a 'model' mesh dim; the mesh has {names}")
        self.mesh = mesh
        self.names = names
        self.seq = bool(seq) and "model" in names and dim_size(mesh, "model") > 1
        # model_rows: the 'model' ranks split each rank's rows further
        # (pure data parallelism over the whole mesh)
        self.model_rows = bool(model_rows) and not self.seq and "model" in names
        rows = tuple(rows) + (("model",) if self.model_rows else ())
        self.rows = tuple(a for a in names if a in rows and a not in manual)
        self.partial = self.rows + (("model",) if self.seq else ())
        self.n_model = dim_size(mesh, "model") if "model" in names else 1
        self.model_rank = mesh.get_local_rank("model") if "model" in names else 0

    @classmethod
    def for_rows(cls, mesh, n_rows: int, rows: tuple, *, seq: bool, manual: tuple = ()):
        """The context of a batch of ``n_rows`` rows held whole on each rank
        (of its manual-dim group): split over ``rows`` (and 'model') where
        they divide the rows, else computed whole."""
        if mesh is None:
            return ONE_RANK
        size = 1
        for a in rows:
            size *= dim_size(mesh, a)
        if n_rows % size:
            rows = ()
            size = 1
        model_rows = (not seq and "model" in mesh.mesh_dim_names
                      and n_rows % (size * dim_size(mesh, "model")) == 0)
        return cls(mesh, rows=rows, seq=seq, manual=manual, model_rows=model_rows)

    def take_rows(self, batch: dict) -> dict:
        """This rank's block of rows (over ``rows``, mesh order, major
        first) of a batch whose rows every rank holds whole."""
        idx, size = 0, 1
        for a in self.rows:
            k = dim_size(self.mesh, a)
            idx, size = idx * k + self.mesh.get_local_rank(a), size * k
        out = {}
        for k, v in batch.items():
            n = v.shape[0] // size
            out[k] = v.narrow(0, idx * n, n)
        return out

    def local_batch(self, batch: dict) -> dict:
        """A batch's leaves as this rank's rows: a DTensor's local rows (cut
        again over 'model' under ``model_rows``); plain tensors are taken as
        this rank's already."""
        out = {}
        for k, v in batch.items():
            if _is_dtensor(v):
                v = v.to_local()
                if self.model_rows:
                    n = v.shape[0] // self.n_model
                    v = v.narrow(0, self.model_rank * n, n)
            out[k] = v
        return out

    # ------------------------------------------------------------ context
    @contextlib.contextmanager
    def entered(self):
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def _act_plan(self) -> tuple:
        """The (tensor dim, mesh dim) all-gather steps from this rank's
        [B_loc, S_loc, ...] to [B, S, ...]: the sequence over 'model', then
        the rows, minor mesh dim first."""
        plan = [(1, "model")] if self.seq else []
        return tuple(plan + [(0, a) for a in reversed(self.rows)])

    # --------------------------------------------------------- parameters
    def param(self, p):
        """A DTensor parameter gathered whole, its gradient reduced back to
        its shards over the dims whose ranks computed on other tokens."""
        from torch.distributed.tensor import Partial, Shard

        mesh = p.device_mesh
        if any(isinstance(pl, Partial) for pl in p.placements):
            raise ValueError(f"a parameter with placements {p.placements}: Shard / Replicate only")
        shards = tuple((pl.dim, a) for a, pl in zip(mesh.mesh_dim_names, p.placements)
                       if isinstance(pl, Shard))
        return _ParamGather.apply(p.to_local(), mesh, shards, self.partial)

    # -------------------------------------------------------- activations
    def seq_slice(self, x, dim: int = 1):
        """The rank's S / model positions of a full-sequence tensor (the
        gradient stays this rank's share: Partial over 'model')."""
        if not self.seq:
            return x
        n = x.shape[dim] // self.n_model
        return x.narrow(dim, self.model_rank * n, n)

    def seq_start(self, s_local: int) -> int:
        return self.model_rank * s_local if self.seq else 0

    def gather_seq(self, x):
        """[B_loc, S / model, ...] -> [B_loc, S, ...]: all-gather over
        'model' (reduce-scatter of the gradient)."""
        if not self.seq:
            return x
        return _Gather.apply(x, self.mesh, ((1, "model"),))

    def gather_tokens(self, x):
        """This rank's [B_loc, S_loc, ...] -> every rank's [B, S, ...]."""
        if not self.partial:
            return x
        return _Gather.apply(x, self.mesh, self._act_plan())

    def scatter_tokens(self, y):
        """Each rank's partial [B, S, ...] summed and split back to the
        ranks' [B_loc, S_loc, ...] (reduce-scatter)."""
        if not self.partial:
            return y
        return _Scatter.apply(y, self.mesh, self._act_plan())

    def share(self, n: int) -> tuple[int, int]:
        """This rank's contiguous share [lo, hi) of n items split over the
        ranks of the partial dims (mesh order, major first)."""
        idx, size = 0, 1
        for a in self.partial:
            k = dim_size(self.mesh, a)
            idx, size = idx * k + self.mesh.get_local_rank(a), size * k
        per = -(-n // size)
        return min(idx * per, n), min((idx + 1) * per, n)

    @property
    def n_partial(self) -> int:
        size = 1
        for a in self.partial:
            size *= dim_size(self.mesh, a)
        return size

    def sum_partial(self, x):
        """Sum of each rank's share over the partial dims, the same on every
        rank; the gradient of each share is the gradient of the sum (1 for
        a loss: every rank differentiates the same value, so the incoming
        gradient is the same on every rank and moves nothing)."""
        if not self.partial:
            return x
        return _SumPartial.apply(x, self.mesh, self.partial)

    def reduce_model(self, x, op: str):
        """All-reduce ``op`` ('sum' / 'max') over 'model' (the split-KV
        decode's combine)."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return _all_reduce(x, self.mesh.get_group("model"), dim_size(self.mesh, "model"), red)

    def softmax_combine(self, s, v_local, eq: str):
        """softmax(s) . v over slots split across 'model' (flash-decode):
        this rank's scores ``s`` [..., slots] against its ``v_local``, the
        max and the sums all-reduced over 'model'; ``eq`` contracts the
        probabilities with v."""
        m = self.reduce_model(torch.amax(s, dim=-1), "max")
        e = torch.exp(s - m[..., None])
        denom = self.reduce_model(torch.sum(e, dim=-1), "sum")
        num = self.reduce_model(torch.einsum(eq, e.to(v_local.dtype), v_local).float(), "sum")
        return num / denom[..., None]

    def cache_view(self, c):
        """(local tensor, first global slot, global slots) of a cache leaf
        whose dim 1 may be split over 'model'."""
        from torch.distributed.tensor import Shard

        if not _is_dtensor(c):
            return c, 0, c.shape[1]
        local = c.to_local()
        for a, pl in zip(self.names, c.placements):
            if isinstance(pl, Shard) and pl.dim == 1:
                if a != "model":
                    raise ValueError(f"cache sequence dim split over {a!r}; only 'model' "
                                     "splits it")
                n = local.shape[1]
                return local, self.mesh.get_local_rank("model") * n, c.shape[1]
        return local, 0, c.shape[1]

    def seq_split(self, c) -> bool:
        """Whether a cache leaf's dim 1 is split over 'model'."""
        from torch.distributed.tensor import Shard

        return _is_dtensor(c) and any(isinstance(pl, Shard) and pl.dim == 1
                                      for pl in c.placements)


ONE_RANK = Spmd(None)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_spmd", default=ONE_RANK)


def local_param(p):
    """``p`` as a layer reads it: a DTensor parameter gathered whole under
    the active mesh context, anything else as it is."""
    if _is_dtensor(p):
        ctx = active()
        if ctx.mesh is None:
            raise RuntimeError("a DTensor parameter was read outside a mesh call; call the "
                               "model through Model.forward / loss_fn / serve_step")
        return ctx.param(p)
    return p
