"""Physical per-host partitioning of an ingested block store (this
package's copy of the JAX package's ``repro.store.shard``, writing the same
bytes).

The SPMD disk engine normally scopes each mesh worker to its stripe range
through a VIRTUAL shard view over one shared directory
(``Manifest.worker_shard_view`` — no bytes move).  On a real multi-host
cluster each host has its own disk, so the store must be physically split:
``split_store`` copies each worker's owned stripe (and packed-index) files
plus the full stats/blocks arrays into a self-contained per-host directory
whose manifest records the ownership range; ``merge_stores`` reassembles the
original store from a complete set of shards.

Both directions are byte-faithful: shard files are copied verbatim (never
re-encoded), every per-worker shard passes ``verify_store`` on its own, and
a split -> merge round trip reproduces the original directory bit-for-bit —
including ``manifest.json``, because ``worker_shard`` is serialized as
*absent* (not null) for a whole store.
"""
from __future__ import annotations

import dataclasses
import os
import shutil

from repro_torch.store import format as fmt
from repro_torch.store.manifest import Manifest, open_store

__all__ = ["split_store", "merge_stores"]

# Whole arrays every shard carries verbatim: degrees drive weight
# reconstruction and θ masks, block measurements drive planning — all of it
# is needed by every worker, and it is O(n + b^2), not O(m).
_BASIC_ARRAYS = ("out_deg", "in_deg", "nnz", "partial_nnz",
                 "rows", "d_max", "deg_hist")


def _whole_arrays(manifest: Manifest) -> tuple[str, ...]:
    if manifest.hybrid is not None:
        return _BASIC_ARRAYS + ("sparse_nnz", "dense_nnz")
    return _BASIC_ARRAYS


def _copy(src: str, dst: str) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copyfile(src, dst)


def _copy_worker_files(src_root: str, dst_root: str, manifest: Manifest,
                       workers) -> None:
    for striping in manifest.stripings():
        for w in workers:
            for a in fmt.STRIPE_ARRAYS:
                _copy(fmt.stripe_path(src_root, striping, w, a),
                      fmt.stripe_path(dst_root, striping, w, a))
    if manifest.has_packed_index:
        for w in workers:
            for a in fmt.PIDX_ARRAYS:
                _copy(fmt.pidx_path(src_root, w, a),
                      fmt.pidx_path(dst_root, w, a))


def split_store(store, out_dir: str, count: int) -> list[Manifest]:
    """Split ``store`` into ``count`` self-contained per-host shard
    directories ``out_dir/shard{w}``; returns their manifests.

    ``count`` must divide ``b`` (contiguous stripe ranges, matching the
    virtual ``worker_shard_view``).  Each shard holds the full stats/blocks
    arrays, only its own stripe + packed-index files, and a manifest whose
    ``worker_shard`` records the ownership range — so ``verify_store`` and
    the disk executors work on a shard exactly as on a whole store.
    """
    manifest = open_store(store)
    if manifest.worker_shard is not None:
        raise ValueError(
            f"{manifest.root}: already a per-host shard "
            f"({manifest.worker_shard}) — split the original whole store")
    shards: list[Manifest] = []
    for w in range(count):
        view = manifest.worker_shard_view(w, count)  # validates count | b
        root = os.path.join(out_dir, f"shard{w}")
        os.makedirs(root, exist_ok=True)
        for name in _whole_arrays(manifest):
            _copy(fmt.array_path(manifest.root, name),
                  fmt.array_path(root, name))
        _copy_worker_files(manifest.root, root, manifest,
                           view.owned_workers())
        shard = dataclasses.replace(view, root=root)
        shard.save()
        shards.append(shard)
    return shards


def merge_stores(shards, out_root: str) -> Manifest:
    """Reassemble a whole store at ``out_root`` from a COMPLETE set of
    per-host shards (paths or Manifests, any order).

    Validates that the shards describe the same ingest (n/m/b/ψ/e_cap/
    checksums) and together cover every stripe range exactly once; raises
    ValueError naming what is missing or inconsistent.  The merged manifest
    drops ``worker_shard``, so merging the shards of ``split_store``
    reproduces the original store byte-for-byte.
    """
    manifests = [open_store(s) for s in shards]
    if not manifests:
        raise ValueError("merge_stores needs at least one shard")
    first = manifests[0]
    for m in manifests:
        if m.worker_shard is None:
            raise ValueError(f"{m.root}: not a per-host shard (no "
                             "worker_shard in its manifest)")
        same = (m.n, m.m, m.b, m.psi, m.symmetrized, m.e_cap, m.partial_cap,
                m.version, m.checksums, m.hybrid) == (
                first.n, first.m, first.b, first.psi, first.symmetrized,
                first.e_cap, first.partial_cap, first.version,
                first.checksums, first.hybrid)
        if not same:
            raise ValueError(
                f"{m.root} and {first.root} are shards of different stores "
                "(manifest fields disagree) — merge one store's shards only")
    count = int(first.worker_shard["count"])
    seen = {int(m.worker_shard["worker"]) for m in manifests}
    missing = sorted(set(range(count)) - seen)
    if missing or len(manifests) != count:
        raise ValueError(
            f"incomplete shard set: have workers {sorted(seen)} of {count}"
            + (f", missing {missing}" if missing else ", duplicates present"))

    os.makedirs(out_root, exist_ok=True)
    for name in _whole_arrays(first):
        _copy(fmt.array_path(first.root, name), fmt.array_path(out_root, name))
    for m in manifests:
        _copy_worker_files(m.root, out_root, m, m.owned_workers())
    merged = dataclasses.replace(first, root=out_root, worker_shard=None)
    merged.save()
    return merged
