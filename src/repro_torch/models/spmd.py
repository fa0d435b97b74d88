"""The mesh context of a sharded model: DTensor parameters, local compute.

``Model.distribute(mesh)`` turns every parameter into a DTensor placed by
``repro_torch.models.sharding.param_shardings`` (the JAX package's 2D rule:
TP dim over 'model', FSDP dim over 'data', replicated over 'pod').  On a
mesh whose 'model' dim is larger than 1 a call then runs tensor parallel
over 'model' (``tp_layout``: the layers whose shards fall on whole heads /
columns) and FSDP over 'data', as GSPMD runs the JAX package's step:

- the batch rows split over the data axes only (``batch_shardings``); the
  'model' ranks hold the same rows;
- a TP layer reads its 'model' shard of each weight (gathered over 'data'
  only, ``tp_shard``) between the Megatron pair over the 'model' group:
  "copy in" (identity; the gradient all-reduced) before its column-parallel
  weights, "reduce out" (all-reduce; the gradient as it is) after its
  row-parallel one; with ``cfg.seq_parallel`` the pair is the all-gather of
  the sequence and its reduce-scatter;
- a TP leaf's gradient comes back reduce-scattered over 'data' (and summed
  over the other data axes), never over 'model'; a replicated leaf read
  inside a TP region (``tp_replica``: q_norm, k_norm) has its gradient
  summed over 'model';
- the other layers (MLA, the SSD, the RG-LRU, cross-attention, and a layer
  whose heads or columns do not divide 'model') gather their weights over
  'model' too and run in the FSDP idiom below, the 'model' ranks splitting
  the rows where they divide them (``rows_split``: the outputs all-gathered
  over 'model'), else computing the same rows; the MoE dispatch splits
  its (expert, slot) pairs over the data axes only, each 'model' rank
  computing its columns of them.

In a decode step, on a mesh without a 'model' dim larger than 1, and
where ``tp_layout`` runs no layer TP, every layer runs in PyTorch's FSDP
idiom:

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
compute the same rows.  A mesh dim listed in ``manual`` (the pod axis
under ``compress_pod``) runs independent steps, its gradients left
unreduced for the caller.  Every cross-rank step is a ``torch.autograd.Function`` over
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

__all__ = ["Spmd", "ONE_RANK", "active", "local_param", "batch_rows", "full_tensor",
           "tp_layout", "describe_layout"]


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


class _CopyIn(torch.autograd.Function):
    """Megatron's "copy in" over ``group``: the identity; the gradient
    (each rank's partial sum, over its shard of a TP layer) all-reduced."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.n), None, None


class _ReduceOut(torch.autograd.Function):
    """Megatron's "reduce out" over ``group``: the all-reduce of each rank's
    partial sum; the gradient as it is (every rank then differentiates the
    same value)."""

    @staticmethod
    def forward(ctx, x, group, n):
        return _all_reduce(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherModel(torch.autograd.Function):
    """All-gather along ``dim`` over 'model'; the gradient reduce-scattered
    where the 'model' ranks hold different parts of it (``partial``), else
    cut to this rank's slice (every rank holds the whole)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank, partial):
        ctx.args = (dim, group, n, rank, partial)
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, rank, partial = ctx.args
        if partial:
            g = _reduce_scatter(g, dim, group, n)
        else:
            k = g.shape[dim] // n
            g = g.narrow(dim, rank * k, k).contiguous()
        return g, None, None, None, None, None


class _SplitModel(torch.autograd.Function):
    """This 'model' rank's block of rows of a tensor every 'model' rank holds
    whole; the gradient (each rank its rows') all-gathered."""

    @staticmethod
    def forward(ctx, x, group, n, rank):
        ctx.args = (group, n)
        k = x.shape[0] // n
        return x.narrow(0, rank * k, k)

    @staticmethod
    def backward(ctx, g):
        group, n = ctx.args
        return _all_gather(g, 0, group, n), None, None, None


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


# layers that always gather their weights over 'model' (no TP path yet)
GATHERED_LAYERS = ("mla", "ssd", "rglru", "cross_attention")


def _kinds(cfg) -> set:
    if cfg.family == "encdec":
        return {"enc", "dec"}
    plan = cfg.scan_plan()
    return set(plan["head"]) | set(plan["pattern"]) | set(plan["tail"])


def tp_layout(cfg, n_model: int) -> dict:
    """How each layer of ``cfg`` runs on a 'model' dim of ``n_model`` ranks
    under tensor parallelism: layer -> 'tp' or the reason it gathers its
    weights over 'model' instead.  A layer runs TP where its 'model' shard
    of every weight falls on whole heads (attention: ``n_heads`` and
    ``n_kv_heads`` divide ``n_model``) or columns (``d_ff``, ``moe_d_ff``,
    ``vocab``).  Only the layers ``cfg`` has are listed."""
    kinds = _kinds(cfg)
    mla = cfg.attn_kind == "mla"
    has = {
        "attention": bool(kinds & {"attn_local", "enc", "dec"})
        or (not mla and bool(kinds & {"self", "dense_ffn", "moe"})),
        "mlp": bool(kinds & {"self", "dense_ffn", "cross", "rglru", "attn_local", "enc",
                             "dec"}),
        "moe": "moe" in kinds,
        "vocab": True,
        "mla": mla and bool(kinds & {"self", "dense_ffn", "moe"}),
        "ssd": "mamba" in kinds,
        "rglru": "rglru" in kinds,
        "cross_attention": bool(kinds & {"cross", "dec"}),
    }
    why = {
        "attention": (cfg.n_heads % n_model or cfg.n_kv_heads % n_model) and
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads on {n_model} 'model' ranks",
        "mlp": cfg.d_ff % n_model and f"d_ff {cfg.d_ff} on {n_model} 'model' ranks",
        "moe": cfg.moe_d_ff % n_model and f"moe_d_ff {cfg.moe_d_ff} on {n_model} 'model' ranks",
        "vocab": cfg.vocab % n_model and f"vocab {cfg.vocab} on {n_model} 'model' ranks",
    }
    out = {}
    for layer, present in has.items():
        if present:
            out[layer] = ("gather: not ported to TP" if layer in GATHERED_LAYERS
                          else f"gather: {why[layer]}" if why[layer] else "tp")
    return out


def describe_layout(layout: dict) -> str:
    """One line of a ``tp_layout``: the TP layers, then the gathered ones."""
    tp = [k for k, v in layout.items() if v == "tp"]
    gathered = [f"{k} ({v[len('gather: '):]})" for k, v in layout.items() if v != "tp"]
    return (f"TP over 'model': {', '.join(tp) or 'none'}"
            + (f"; gathered over 'model': {', '.join(gathered)}" if gathered else ""))


class Spmd:
    """One call's layout on ``mesh``: ``rows`` the mesh dims splitting the
    batch rows, ``seq`` whether 'model' splits the sequence, ``manual``
    mesh dims whose ranks run independent steps, ``tp`` the layers that run
    tensor parallel over 'model' (``tp_layout``'s).  ``mesh=None`` is one
    rank holding every row, position and (expert, slot) pair (``ONE_RANK``,
    the model off a mesh): every method is then the identity."""

    def __init__(self, mesh, *, rows: tuple = (), seq: bool = False, manual: tuple = (),
                 model_rows: bool = False, tp=()):
        names = () if mesh is None else mesh.mesh_dim_names
        if seq and mesh is not None and "model" not in names:
            raise ValueError(f"seq_parallel needs a 'model' mesh dim; the mesh has {names}")
        self.mesh = mesh
        self.names = names
        self.n_model = dim_size(mesh, "model") if "model" in names else 1
        self.model_rank = mesh.get_local_rank("model") if "model" in names else 0
        self.seq = bool(seq) and self.n_model > 1
        self.tp = frozenset(tp) if self.n_model > 1 else frozenset()
        # model_rows: the 'model' ranks split each rank's rows further
        # (pure data parallelism over the whole mesh); never under TP
        self.model_rows = bool(model_rows) and not self.seq and not self.tp and "model" in names
        rows = tuple(rows) + (("model",) if self.model_rows else ())
        self.rows = tuple(a for a in names if a in rows and a not in manual)
        self.partial = self.rows + (("model",) if self.seq else ())

    @classmethod
    def for_rows(cls, mesh, n_rows: int, rows: tuple, *, seq: bool, manual: tuple = (),
                 tp=()):
        """The context of a batch of ``n_rows`` rows held whole on each rank
        (of its manual-dim group): split over ``rows`` (and, without TP,
        'model') where they divide the rows, else computed whole."""
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
        return cls(mesh, rows=rows, seq=seq, manual=manual, model_rows=model_rows, tp=tp)

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
    def _shards(self, p) -> tuple:
        from torch.distributed.tensor import Partial, Shard

        if any(isinstance(pl, Partial) for pl in p.placements):
            raise ValueError(f"a parameter with placements {p.placements}: Shard / Replicate only")
        return tuple((pl.dim, a) for a, pl in zip(p.device_mesh.mesh_dim_names, p.placements)
                     if isinstance(pl, Shard))

    def param(self, p):
        """A DTensor parameter gathered whole, its gradient reduced back to
        its shards over the dims whose ranks computed on other tokens."""
        return _ParamGather.apply(p.to_local(), p.device_mesh, self._shards(p), self.partial)

    def tp_shard(self, p):
        """A TP layer's weight: its 'model' shard, gathered over the other
        dims that shard it; the gradient (this shard's whole, computed on
        every position of the rows) reduced over the row dims only."""
        if not _is_dtensor(p):
            return p
        shards = self._shards(p)
        if "model" not in {a for _, a in shards}:
            raise ValueError(f"a tensor-parallel layer's weight of shape {tuple(p.shape)} is not "
                             f"sharded over 'model' ({p.placements}); place it by "
                             "param_shardings")
        partial = tuple(a for a in self.partial if a != "model")
        return _ParamGather.apply(p.to_local(), p.device_mesh,
                                  tuple(s for s in shards if s[1] != "model"), partial)

    def tp_replica(self, p):
        """A leaf replicated over 'model' that a TP layer reads on its own
        heads (q_norm, k_norm): gathered whole; its gradient also summed
        over 'model'."""
        if not _is_dtensor(p):
            return p
        partial = self.partial + (() if "model" in self.partial else ("model",))
        return _ParamGather.apply(p.to_local(), p.device_mesh, self._shards(p), partial)

    # ---------------------------------------------------- tensor parallel
    def tp_on(self, layer: str) -> bool:
        """Whether ``layer`` (a ``tp_layout`` name) runs tensor parallel."""
        return layer in self.tp

    def _model_group(self):
        return self.mesh.get_group("model")

    def copy_in(self, x):
        """Megatron's "copy in" over 'model' where the 'model' ranks hold the
        same tokens (without seq_parallel); the identity where their
        gradients are summed later anyway ('model' in ``partial``)."""
        if not self.tp or "model" in self.partial:
            return x
        return _CopyIn.apply(x, self._model_group(), self.n_model)

    def reduce_out(self, y):
        """Megatron's "reduce out" over 'model' (all-reduce forward), paired
        with :meth:`copy_in`."""
        if not self.tp or "model" in self.partial:
            return y
        return self.psum_model(y)

    def psum_model(self, y):
        """All-reduce over 'model'; the gradient as it is."""
        if self.n_model == 1:
            return y
        return _ReduceOut.apply(y, self._model_group(), self.n_model)

    def tp_in(self, x):
        """A TP layer's input from this rank's residual stream: its whole
        sequence (all-gather over 'model' under seq_parallel, the gradient
        reduce-scattered), else ``copy_in``."""
        return self.gather_seq(x) if self.seq else self.copy_in(x)

    def tp_out(self, y):
        """A TP layer's partial output back to the residual stream: the
        reduce-scatter of the sequence over 'model' under seq_parallel (the
        gradient all-gathered), else ``reduce_out``."""
        if self.seq:
            return _Scatter.apply(y, self.mesh, ((1, "model"),))
        return self.reduce_out(y)

    def splits_rows(self, x) -> bool:
        """Whether :meth:`rows_split` splits ``x``'s rows: under TP without
        seq_parallel, where the 'model' ranks divide them."""
        return bool(self.tp) and not self.seq and x.shape[0] % self.n_model == 0

    def rows_split(self, fn, *xs):
        """``fn(*xs)`` for a layer that gathers its weights over 'model' while
        others run TP (:meth:`splits_rows` must hold): the 'model' ranks
        split the rows of ``xs`` (each a [B_loc, ...] tensor every 'model'
        rank holds whole), each computes its rows in the FSDP idiom (its
        weights' gradients summed over 'model' too), and the outputs are
        all-gathered over 'model'."""
        group, n, rank = self._model_group(), self.n_model, self.model_rank
        sub = Spmd(self.mesh, rows=self.rows, model_rows=True)
        parts = [_SplitModel.apply(x, group, n, rank) for x in xs]
        with sub.entered():
            y = fn(*parts)
        return _GatherModel.apply(y, 0, group, n, rank, False)

    def gather_model(self, x, dim: int):
        """``x``'s 'model' shards along ``dim`` concatenated (vocab-parallel
        logits made whole)."""
        if self.n_model == 1:
            return x
        return _GatherModel.apply(x, dim % x.ndim, self._model_group(), self.n_model,
                                  self.model_rank, "model" in self.partial)

    def sum_rows(self, x):
        """Sum over the row dims only (a value every 'model' rank holds
        whole); the gradient as it is."""
        if not self.rows:
            return x
        return _SumPartial.apply(x, self.mesh, self.rows)

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

    def share(self, n: int, *, tp: bool = False) -> tuple[int, int]:
        """This rank's contiguous share [lo, hi) of n items split over the
        ranks of the partial dims (mesh order, major first); ``tp``: not over
        'model' (its ranks split each item's columns instead)."""
        idx, size = 0, 1
        for a in self.partial:
            if tp and a == "model":
                continue
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
