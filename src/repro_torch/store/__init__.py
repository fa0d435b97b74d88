"""repro_torch.store: the out-of-core pre-partitioned block store (the
paper's one-off pre-partitioning, persisted) with schedule-driven prefetch;
this package's counterpart of the JAX package's ``repro.store``, reading and
writing the same bytes.

    ingest_edges(...)              stream an edge list into a store directory
    open_store(path)               -> Manifest
    load_partitioned(store, spec)  bitwise partition_graph reconstruction
    PMVEngine(None, store=..., residency='disk')  out-of-core execution
                                   (vertical, horizontal, θ-split hybrid)
    PMVServer(store=..., residency=...)           serving from a store
    verify_store(store)            audit every shard against ingest checksums

Not ported yet: ``shard.py`` (split / merge of per-host stores) and
``spmd.py``.
"""
from repro_torch.store.ingest import ingest_edges
from repro_torch.store.manifest import (
    Manifest,
    ManifestCorruptError,
    ManifestVersionError,
    ShardCorruptError,
    load_partitioned,
    open_store,
    plan_from_manifest,
)
from repro_torch.store.residency import (
    RESIDENCY_MODES,
    DiskBlockStore,
    DiskExecutor,
    HybridDiskExecutor,
    PrefetchPipeline,
    ResidencyStats,
    make_disk_step,
)
from repro_torch.store.verify import VerifyReport, verify_store

__all__ = [
    "ingest_edges",
    "Manifest",
    "ManifestCorruptError",
    "ManifestVersionError",
    "ShardCorruptError",
    "open_store",
    "load_partitioned",
    "plan_from_manifest",
    "RESIDENCY_MODES",
    "DiskBlockStore",
    "DiskExecutor",
    "HybridDiskExecutor",
    "PrefetchPipeline",
    "ResidencyStats",
    "make_disk_step",
    "VerifyReport",
    "verify_store",
]
