"""Collective and memory accounting of one traced step (the JAX package's
``repro.launch.hlo_analysis``, over what PyTorch records instead of XLA HLO).

The JAX package reads the compiled post-SPMD HLO text and multiplies each
collective by its while-loop trip counts.  The port has no HLO: its dry run
(``repro_torch.launch.dryrun``) traces one step eagerly under
``FakeTensorMode`` on a fake process group, and ``CollectiveRecorder`` (a
``TorchDispatchMode``) records every collective op as it is dispatched --
the in-place ``c10d.*`` ones the port issues (``torch.distributed``'s
all-gather, reduce-scatter, all-reduce, all-to-all, send / recv) and the
functional ones (``_c10d_functional.*``) DTensor issues -- with the bytes
of its result on this rank.
Eager tracing runs every layer and every microbatch, so each record is one
execution: no trip-count inference is needed, and ``bytes`` equals
``raw_bytes``.  Totals are per-rank wire bytes per executed step, as the
JAX package's are per device.

``MemoryRecorder`` tracks the live storages of the step's tensors (fake
ones included) for ``compiled_memory_stats``.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["collective_totals", "parse_computations", "compiled_memory_stats"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

# op name (without namespace and overload) -> kind
_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _kind(func) -> str | None:
    ns = getattr(func, "namespace", None)
    if ns not in _NAMESPACES:
        return None
    return _OPS.get(func._schema.name.split("::")[-1])


def _group_name(args) -> str | None:
    """The name of the process group a collective runs on: a c10d op's
    torchbind argument, a functional op's last string argument."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in a._type().qualified_name():
            return dist.ProcessGroup.unbox(a).group_name
    names = [a for a in args if isinstance(a, str)]
    return names[-1] if names else None


class CollectiveRecorder(TorchDispatchMode):
    """Records (kind, result bytes, description) of every collective op
    dispatched while it is active; with a ``mesh`` also the mesh dim whose
    process group each one ran on (``dims``, one entry a record: the dim's
    name, or None for another group)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.records: list = []
        self.dims: list = []
        self._names = ({} if mesh is None else
                       {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _kind(func)
        if kind is not None:
            # a c10d op writes its result into its first argument (and
            # returns a Work handle, or that argument and one)
            res = args[0] if func.namespace == "c10d" else out
            shapes = [tuple(t.shape) for t in _tensors(res)]
            self.records.append((kind, _nbytes(res), f"{func} {shapes}"))
            self.dims.append(self._names.get(_group_name(args)) if self._names else None)
        return out

    def by_dim(self) -> dict:
        """{mesh dim: {kind: [count, result bytes]}} of the records."""
        out: dict = {}
        for (kind, nbytes, _), dim in zip(self.records, self.dims):
            c = out.setdefault(dim, {}).setdefault(kind, [0, 0.0])
            c[0] += 1
            c[1] += nbytes
        return out


class MemoryRecorder(TorchDispatchMode):
    """Peak bytes of the storages that ops allocate while it is active
    (views and in-place results share their input's storage and count
    once); a storage counts until it is freed."""

    def __init__(self):
        super().__init__()
        self.live = 0.0
        self.peak = 0.0
        self._seen: dict = {}

    def _track(self, t: torch.Tensor):
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        if key in self._seen:
            return
        n = float(st.nbytes())
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._seen.pop(key, 0.0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if type(t).__name__ != "DTensor":
                self._track(t)
        return out


def compiled_memory_stats(record) -> dict:
    """Peak-memory accounting of one traced step, under the JAX package's
    keys.  ``record``: {'argument_bytes': this rank's local shards of the
    step's inputs, 'output_bytes': of its new outputs, 'alias_bytes': of the
    outputs written into the inputs (donated), 'temp_bytes': the
    ``MemoryRecorder`` peak of the step's own allocations}.
    ``generated_code_bytes`` has no torch meaning and reads 0; ``peak_bytes``
    is temp + arguments + outputs, as in the JAX package."""
    out = {k: float(record.get(k, 0.0)) for k in
           ("temp_bytes", "argument_bytes", "output_bytes", "alias_bytes")}
    out["generated_code_bytes"] = 0.0
    out["peak_bytes"] = out["temp_bytes"] + out["argument_bytes"] + out["output_bytes"]
    return out


def parse_computations(hlo: str) -> dict:
    """XLA HLO text is what the JAX package parses; the port never produces
    any (its dry run records collectives as they are dispatched), so
    parse_computations is not available in repro_torch."""
    raise NotImplementedError(
        "parse_computations reads XLA HLO text, which repro_torch never produces; its dry run "
        "records collectives as they are dispatched (CollectiveRecorder, collective_totals)")


def collective_totals(record) -> dict:
    """Totals of the collectives recorded while one step was traced.

    ``record``: a ``CollectiveRecorder`` or its records, (kind, bytes,
    description) each.  Returns the JAX package's dict: ``bytes`` per kind
    under its five kind names plus ``total``, ``raw_bytes`` (equal: every
    record is one execution), ``counts`` and ``top`` (the 12 largest)."""
    records = record.records if isinstance(record, CollectiveRecorder) else list(record)
    totals = {k: 0.0 for k in KINDS}
    counts = {k: 0 for k in KINDS}
    top = []
    for kind, byt, line in records:
        totals[kind] += byt
        counts[kind] += 1
        top.append({"kind": kind, "bytes": byt, "mult": 1.0, "effective": byt,
                    "comp": line.split(" ", 1)[0], "line": line[:160]})
    top.sort(key=lambda r: -r["effective"])
    return {
        "bytes": {**totals, "total": sum(totals.values())},
        "raw_bytes": {**totals, "total": sum(totals.values())},
        "counts": counts,
        "top": top[:12],
    }
