"""Sharding rules for params / batches / caches on a device mesh (the JAX
package's ``repro.models.sharding``, on a torch ``DeviceMesh``).

Policy (the JAX package's):
- 2D weight sharding: every large matrix is sharded over BOTH mesh axes —
  TP on the "parallel" dim ('model') and FSDP/ZeRO-3 on the other ('data').
  Optimizer moments inherit the same specs.  Weights are replicated across
  'pod' (pure cross-pod DP).
- Specs are right-aligned: a rule gives the spec of the *core* trailing dims
  and any extra leading dims (the expert axis) are replicated.  The port
  keeps one module per layer where the JAX package stacks a scanned stack's
  layers under a leading axis, so a port spec is the JAX spec with that
  (always replicated) axis removed.
- Batch dims shard over ('pod','data') when divisible, else replicate.
- Full-attention KV caches shard their sequence dim over 'model'
  (flash-decode style split-KV); ring/window caches and SSM states are small
  and shard over batch only.
- An axis that does not divide its dim is dropped (the dim replicates).

A spec is a tuple with one entry per tensor dim: None, a mesh dim name, or
a tuple of names (the dim split over several mesh dims, major first): the
counterpart of ``PartitionSpec``.  Trees are nested dicts / lists whose
leaves have a ``.shape`` (tensors, real, fake or on the meta device); a
flat dict keyed ``'blocks.3.l0.attn.wq'`` (``Model.params()``) names each
leaf by its last component.  ``placements(spec, mesh)`` gives the DTensor
placements of every mesh dim and ``sds_with`` places a tree on the mesh.
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes, data_axes

__all__ = ["param_shardings", "batch_shardings", "cache_shardings", "sds_with"]

# rule: leaf name -> spec of trailing core dims
_RULES = {
    "wte": ("model", "data"),
    "lm_head": ("data", "model"),
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "w_q": ("data", "model"), "w_dkv": ("data", "model"),
    "w_in": ("data", "model"), "w_x": ("data", "model"),
    "w_gate_branch": ("data", "model"), "w_r": ("data", "model"), "w_i": ("data", "model"),
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "wo": ("model", "data"), "w_o": ("model", "data"),
    "w_down": ("model", "data"), "w_out": ("model", "data"),
    "w_uk": (None, "model"), "w_uv": (None, "model"),
    "router": ("data", None),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
}

# core dims of a cache leaf ([B, S|N, ...]); the rest lead
_CACHE_CORE_NDIM = {"k": 4, "v": 4, "xk": 4, "xv": 4, "c_kv": 3, "k_rope": 3,
                    "conv": 3, "state": 4, "h": 2}
_SEQ_SHARDED = ("k", "v", "c_kv", "k_rope", "xk", "xv")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_for(name: str, ndim: int, shape, mesh) -> tuple:
    core = _RULES.get(name, ())
    core = core[-ndim:] if ndim < len(core) else core
    spec = (None,) * (ndim - len(core)) + tuple(core)
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, ax in zip(shape, spec):
        size = 1
        for a in _axes(ax):
            size *= sizes[a]
        fixed.append(ax if ax is not None and dim % size == 0 else None)
    return tuple(fixed)


def _leaf_name(key) -> str:
    return key.rsplit(".", 1)[-1] if isinstance(key, str) else str(key)


def _map(fn, tree, key=None):
    """fn(leaf name, leaf) over the leaves of nested dicts / lists."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, i) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(_leaf_name(key), tree)


def param_shardings(params_shapes, mesh):
    """A spec per leaf of a parameter tree, or of a train state: the
    moments mirror the parameters and scalars replicate."""
    return _map(lambda name, leaf: _spec_for(name, len(leaf.shape), tuple(leaf.shape), mesh),
                params_shapes)


def _batch_axes(mesh, batch_size: int):
    dp = data_axes(mesh)
    sizes = axis_sizes(mesh)
    total = 1
    for a in dp:
        total *= sizes[a]
    return dp if batch_size % total == 0 else None


def batch_shardings(batch_shapes, mesh):
    def shard_one(_name, leaf):
        return (_batch_axes(mesh, leaf.shape[0]),) + (None,) * (len(leaf.shape) - 1)
    return _map(shard_one, batch_shapes)


def cache_shardings(cache_shapes, mesh, cfg):
    """Cache sharding, right-aligned on the *core* dims of a cache leaf:
    - batch dim over ('pod','data') when divisible;
    - a long sequence dim (full-attn KV, MLA latents) over 'model'
      (split-KV flash-decode) when ``cfg.decode_seq_shard``, it divides and
      is at least 4x the axis; ring/window caches and SSM states
      batch-only.
    """
    mdl = axis_sizes(mesh)["model"]

    def shard_one(name, leaf):
        shape = tuple(leaf.shape)
        nd = _CACHE_CORE_NDIM.get(name, len(shape))
        lead = len(shape) - nd
        if lead not in (0, 1):
            raise ValueError(f"cache leaf {name!r} of shape {shape}: {lead} leading dims")
        b_dim, s_dim = lead, lead + 1
        spec = [None] * len(shape)
        spec[b_dim] = _batch_axes(mesh, shape[b_dim])
        seq_shardable = (
            name in _SEQ_SHARDED
            and nd >= 2
            and shape[s_dim] >= 4 * mdl
            and shape[s_dim] % mdl == 0
            and cfg.decode_seq_shard
        )
        if seq_shardable:
            spec[s_dim] = "model"
        return tuple(spec)

    return _map(shard_one, cache_shapes)


def placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d names the mesh dim, ``Replicate()``
    elsewhere.  A dim split over several mesh dims takes them in mesh order
    (major first), which gives each rank the slice JAX gives its device."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    where = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} splits over {axes}, not in the mesh's "
                             f"dim order {names}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} names mesh dim {a!r} twice")
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)


def sds_with(tree, shardings, mesh, *, src_data_rank: int | None = 0):
    """Place each tensor of ``tree`` on ``mesh`` under its spec
    (``distribute_tensor``).  ``src_data_rank`` as ``distribute_tensor``
    takes it: None keeps each rank's own copy (equal on every rank, or fake)
    without a broadcast."""
    from torch.distributed.tensor import distribute_tensor

    def place(leaf, spec):
        if leaf is None:
            return None
        if isinstance(leaf, (dict, list, tuple)):
            if isinstance(leaf, dict):
                return {k: place(leaf[k], spec[k]) for k in leaf}
            return type(leaf)(place(v, s) for v, s in zip(leaf, spec))
        return distribute_tensor(leaf, mesh, placements(spec, mesh),
                                 src_data_rank=src_data_rank)

    return place(tree, shardings)
