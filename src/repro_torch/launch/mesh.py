"""Production mesh construction (the JAX package's ``repro.launch.mesh``).

A function, not a module-level constant: importing this module initialises
nothing.  ``make_production_mesh`` builds a ``DeviceMesh`` over the process
group the caller has initialised (``torch.distributed.init_process_group``,
or the dry run's ``"fake"`` group of 256 or 512 ranks).

``AbstractMesh`` is the counterpart of ``jax.sharding.AbstractMesh``: a
shape and dim names without ranks, enough for the sharding rules of
``repro_torch.models.sharding`` (a production mesh's specs without its 256
processes).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "data_axes", "model_axis", "worker_axes"]

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class AbstractMesh:
    """A mesh's shape and dim names, with no process group behind it."""

    def __init__(self, shape, names):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and dim names {tuple(names)} differ "
                             "in length")
        self.mesh_dim_names = tuple(names)
        self.shape = tuple(int(s) for s in shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def size(self, mesh_dim: int | None = None) -> int:
        if mesh_dim is None:
            n = 1
            for s in self.shape:
                n *= s
            return n
        return self.shape[mesh_dim]

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def axis_sizes(mesh) -> dict:
    """{dim name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no dim names; build it with mesh_dim_names=")
    return dict(zip(names, (int(s) for s in mesh.shape)))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(16, 16) ('data', 'model'), or (2, 16, 16) ('pod', 'data', 'model')
    with ``multi_pod``, over the default process group, whose world size
    must be the mesh's size.  ``device_type`` defaults to 'cuda'."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    want = 1
    for s in shape:
        want *= s
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh {shape} needs an initialised process group "
                           f"of {want} ranks (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world != want:
        raise ValueError(f"the production mesh {names} {shape} needs a world size of {want}; "
                         f"the process group has {world} (the single-pod mesh takes 256 ranks, "
                         "the multi-pod mesh 512)")
    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=names)


def data_axes(mesh) -> tuple:
    """Axes that shard the batch: ('pod','data') on the multi-pod mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def worker_axes(mesh) -> tuple:
    """All axes flattened into the PMV engine's 1-D worker axis (paper model:
    b = number of workers)."""
    return tuple(mesh.mesh_dim_names)
