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
    PMVEngine(None, store=..., residency='disk', mesh=...)  out of core
                                   across W ranks, each on its own shard view
                                   (SpmdDiskGroup)
    split_store / merge_stores     physical per-host shards and back
    verify_store(store)            audit every shard against ingest checksums
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
from repro_torch.store.shard import merge_stores, split_store
from repro_torch.store.spmd import SpmdDiskGroup, SpmdPrefetchPipeline
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
    "SpmdDiskGroup",
    "SpmdPrefetchPipeline",
    "split_store",
    "merge_stores",
    "VerifyReport",
    "verify_store",
]
