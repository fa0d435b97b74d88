"""Whole-store integrity audit (this package's counterpart of the JAX
package's ``repro.store.verify``).

``verify_store(store)`` re-reads every persisted array and stripe shard and
checks it against the manifest's ingest-time digests: whole-array digests
for the degree / per-block measurement arrays, per-block-row digests for the
seg/gat edge shards (the disk executor's fetch unit) and whole-array digests
for the counts.  The report lists every mismatch with the same precise
diagnosis :class:`~repro_torch.store.manifest.ShardCorruptError` carries, so a
failing audit names the exact file / worker / block row to restore.

This is the offline complement to the online check: ``DiskBlockStore``
verifies each slice as it is fetched (catching corruption on the hot path,
where a retry can still recover), while ``verify_store`` audits everything
once — run it after a restore, before a long solve, or from CI.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.store import format as fmt
from repro_torch.store.manifest import Manifest, open_store

__all__ = ["VerifyReport", "verify_store"]

_WHOLE_ARRAYS = ("out_deg", "in_deg", "nnz", "partial_nnz",
                 "rows", "d_max", "deg_hist")


@dataclasses.dataclass
class VerifyReport:
    """Outcome of one store audit."""

    root: str
    algorithm: str | None
    checked: int = 0                 # digests compared
    mismatches: list = dataclasses.field(default_factory=list)
    missing: list = dataclasses.field(default_factory=list)  # absent files
    skipped: bool = False            # pre-checksum store: nothing to verify

    @property
    def ok(self) -> bool:
        return not self.mismatches and not self.missing and not self.skipped

    def summary(self) -> str:
        if self.skipped:
            return (f"{self.root}: manifest has no checksums (pre-integrity "
                    "store) — re-ingest to enable verification")
        head = (f"{self.root}: {self.checked} digests checked "
                f"({self.algorithm}), {len(self.mismatches)} mismatched, "
                f"{len(self.missing)} missing")
        lines = [head]
        lines += [f"  CORRUPT {m}" for m in self.mismatches]
        lines += [f"  MISSING {m}" for m in self.missing]
        return "\n".join(lines)


def _check(report: VerifyReport, where: str, expected: str, actual: str) -> None:
    report.checked += 1
    if expected != actual:
        report.mismatches.append(
            f"{where}: expected {expected}, read {actual}")


def verify_store(store) -> VerifyReport:
    """Audit every shard of ``store`` (path or Manifest) against its
    manifest digests; never raises on corruption — returns the full report
    so one audit surfaces EVERY bad shard, not just the first."""
    manifest: Manifest = open_store(store)
    algo = manifest.checksum_algorithm
    report = VerifyReport(root=manifest.root, algorithm=algo)
    if not manifest.checksums:
        report.skipped = True
        return report

    whole = _WHOLE_ARRAYS + (("sparse_nnz", "dense_nnz")
                             if manifest.hybrid is not None else ())
    # Per-host shard manifests (worker_shard) only hold their own stripe
    # files — audit exactly the owned workers so a shard verifies clean.
    owned = list(manifest.owned_workers())
    for name in whole:
        expected = manifest.checksums.get("arrays", {}).get(name)
        if expected is None:
            continue
        path = fmt.array_path(manifest.root, name)
        if not os.path.exists(path):
            report.missing.append(path)
            continue
        _check(report, f"{path} [{name}]",
               expected, fmt.checksum_array(np.asarray(manifest.array(name)), algo))

    for striping in manifest.stripings():
        for w in owned:
            sums = manifest.stripe_checksums(striping, w)
            if sums is None:
                continue
            paths = {a: fmt.stripe_path(manifest.root, striping, w, a)
                     for a in fmt.STRIPE_ARRAYS}
            if any(not os.path.exists(p) for p in paths.values()):
                report.missing += [p for p in paths.values()
                                   if not os.path.exists(p)]
                continue
            seg, gat, cnt = manifest.stripe_arrays(striping, w, mmap=True)
            for k in range(manifest.b):
                _check(report, f"{paths['seg']} [row {k}]",
                       sums["seg"][k], fmt.checksum_array(np.asarray(seg[k]), algo))
                _check(report, f"{paths['gat']} [row {k}]",
                       sums["gat"][k], fmt.checksum_array(np.asarray(gat[k]), algo))
            _check(report, paths["cnt"],
                   sums["cnt"], fmt.checksum_array(np.asarray(cnt), algo))

    pidx_sums = manifest.checksums.get("pidx")
    if pidx_sums:
        for w in owned:
            paths = {a: fmt.pidx_path(manifest.root, w, a)
                     for a in fmt.PIDX_ARRAYS}
            if any(not os.path.exists(p) for p in paths.values()):
                report.missing += [p for p in paths.values()
                                   if not os.path.exists(p)]
                continue
            for name in fmt.PIDX_ARRAYS:
                arr = np.asarray(fmt.open_array(paths[name]))
                _check(report, f"{paths[name]} [pidx.{name}]",
                       pidx_sums[w][name], fmt.checksum_array(arr, algo))
    return report
