"""On-disk layout of the pre-partitioned block store (repro_torch.store;
this package's own copy of the JAX package's ``repro.store.format``: both
packages read and write the same bytes).

A store directory holds one pre-partitioning of one graph:

    <dir>/manifest.json                  versioned metadata (manifest.py)
    <dir>/stats/out_deg.npy, in_deg.npy  [n] int64 degree arrays
    <dir>/blocks/nnz.npy                 [b, b] int64  == block_nnz[i, j]
    <dir>/blocks/partial_nnz.npy         [b, b] int64  structural |v^(i,j)|
    <dir>/blocks/rows.npy, d_max.npy     [b, b] int64  planner measurements
    <dir>/blocks/deg_hist.npy            [b, b, H] int64 pow2 degree histogram
    <dir>/vertical/w{j}.seg.npy ...      per-worker stripe shards
    <dir>/horizontal/w{i}.seg.npy ...
    <dir>/vertical/w{j}.pidx.words.npy   packed exchange index shards (v2):
    <dir>/vertical/w{j}.pidx.meta.npy    per-(dst block, src worker j) wire-
                                         codec id sets, flat uint32 words +
                                         [b, 3] int64 (word offset, count,
                                         bit width) — repro_torch.exchange.codec

Shards are plain ``.npy`` files so ``np.load(mmap_mode='r')`` gives zero-copy
memmap access for the disk-residency executor.  Each stripe shard holds the
exact arrays ``blocks.BlockEdges`` carries in memory — seg_local / gat_local
[b, E_cap] int32 and count [b] int32, padded to the GLOBAL E_cap so a loaded
stripe is bitwise ``partition_graph``'s output.  Matrix values (w) are NOT
stored: they are a per-spec elementwise function of out-degree
(partition.edge_weights_for), recomputed at load/fetch time, which keeps one
ingested store serving every GIM-V algorithm.
"""
from __future__ import annotations

import os
import zlib

import numpy as np

__all__ = [
    "FORMAT_NAME",
    "FORMAT_VERSION",
    "STRIPINGS",
    "STRIPE_ARRAYS",
    "PIDX_ARRAYS",
    "nnz_array_of",
    "CHECKSUM_ALGORITHM",
    "stripe_path",
    "pidx_path",
    "array_path",
    "save_array",
    "open_array",
    "checksum_fn",
    "checksum_bytes",
    "checksum_array",
    "row_checksums",
    "pack_worker_stripe",
    "EdgeBins",
]

FORMAT_NAME = "pmv-block-store"
# v2 adds the packed-exchange index shards (vertical/w{j}.pidx.*) that the
# packed transport ships once instead of re-sending (idx, val) pairs each
# iteration.  v1 stores still load for every non-packed path; requesting the
# packed exchange against one raises manifest.ManifestVersionError.
FORMAT_VERSION = 2

# ---------------------------------------------------------------------------
# Integrity checksums.  Digests cover the RAW ARRAY BYTES (not the
# .npy container), at the granularity the disk-residency executor reads: one
# digest per block row for seg/gat (fetch verifies exactly the rows it read),
# one per whole array for cnt / degree / measurement arrays (read whole).
# crc32c (Castagnoli, the storage-stack standard) is used when the optional
# ``crc32c`` package is importable; otherwise the stdlib zlib.crc32 — the
# algorithm is recorded in the manifest so readers always verify with the
# one the store was written with.
# ---------------------------------------------------------------------------

try:  # pragma: no cover - exercised only where the wheel is installed
    from crc32c import crc32c as _crc32c_fn

    CHECKSUM_ALGORITHM = "crc32c"
except ImportError:
    _crc32c_fn = None
    CHECKSUM_ALGORITHM = "crc32"


def checksum_fn(algorithm: str):
    """Digest function for ``algorithm`` (raises if this host can't verify a
    store written with an algorithm it doesn't have)."""
    if algorithm == "crc32":
        return zlib.crc32
    if algorithm == "crc32c":
        if _crc32c_fn is None:
            raise RuntimeError(
                "store was checksummed with crc32c but the crc32c package "
                "is not installed — install it or re-ingest the store")
        return _crc32c_fn
    raise ValueError(f"unknown checksum algorithm {algorithm!r}")


def checksum_bytes(data, algorithm: str = CHECKSUM_ALGORITHM) -> str:
    return format(checksum_fn(algorithm)(bytes(data)) & 0xFFFFFFFF, "08x")


def checksum_array(arr: np.ndarray, algorithm: str = CHECKSUM_ALGORITHM) -> str:
    """Digest of the array's raw bytes: the same digest as
    ``checksum_bytes(arr.tobytes())``, read through the buffer protocol so
    a fetched slice is not copied once more to be checked."""
    return format(checksum_fn(algorithm)(np.ascontiguousarray(arr)) & 0xFFFFFFFF, "08x")


def row_checksums(arr: np.ndarray, algorithm: str = CHECKSUM_ALGORITHM) -> list[str]:
    """One digest per leading-axis row — the fetch unit of a stripe shard."""
    return [checksum_array(arr[k], algorithm) for k in range(arr.shape[0])]

STRIPE_ARRAYS = ("seg", "gat", "cnt")
# The two basic stripings plus the θ-split hybrid pair: sparse-region edges
# laid out vertically (src out-degree < θ) and dense-region edges laid out
# horizontally with compact dense SLOTS in the gather column (src >= θ).
STRIPINGS = ("vertical", "horizontal", "sparse_vertical", "dense_horizontal")
_ARRAY_DIRS = {
    "out_deg": "stats", "in_deg": "stats",
    "nnz": "blocks", "partial_nnz": "blocks",
    "rows": "blocks", "d_max": "blocks", "deg_hist": "blocks",
    "sparse_nnz": "blocks", "dense_nnz": "blocks",
}


def nnz_array_of(striping: str) -> str:
    """The [b, b] block-nnz array a striping's launch schedule derives from:
    the full matrix for the basic stripings, the θ-split region counts for
    the hybrid pair."""
    if striping == "sparse_vertical":
        return "sparse_nnz"
    if striping == "dense_horizontal":
        return "dense_nnz"
    return "nnz"


def array_path(root: str, name: str) -> str:
    return os.path.join(root, _ARRAY_DIRS[name], f"{name}.npy")


def stripe_path(root: str, striping: str, worker: int, array: str) -> str:
    assert striping in STRIPINGS, striping
    assert array in STRIPE_ARRAYS, array
    return os.path.join(root, striping, f"w{worker}.{array}.npy")


PIDX_ARRAYS = ("words", "meta")


def pidx_path(root: str, worker: int, array: str) -> str:
    """Packed-exchange index shard of one VERTICAL worker (v2 stores): the
    wire-codec id sets of every (dst block i, src worker j) pair, as flat
    uint32 delta-field words plus a [b, 3] int64 (word offset, id count, bit
    width) directory — exactly what exchange.codec.unpack_fields decodes."""
    assert array in PIDX_ARRAYS, array
    return os.path.join(root, "vertical", f"w{worker}.pidx.{array}.npy")


def save_array(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, arr)


def open_array(path: str, *, mmap: bool = False) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"store shard missing: {path} — incomplete or corrupted store "
            "directory; re-run repro_torch.store.ingest_edges")
    return np.load(path, mmap_mode="r" if mmap else None)


def pack_worker_stripe(
    inner: np.ndarray,
    seg_local: np.ndarray,
    gat_local: np.ndarray,
    b: int,
    e_cap: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One worker's bin of edges -> padded stripe arrays, exactly as
    ``blocks.build_stripes`` lays out that worker's slice.

    ``inner`` is the inner block id of each edge (destination block for
    vertical stripes, source block for horizontal), seg_local/gat_local the
    local indices.  The stable lexsort by (inner, seg_local) is
    build_stripes' global stable (owner, inner, seg_local) order restricted
    to one owner, so per-bin packing reproduces the in-memory stripe
    bitwise given the global ``e_cap``.
    """
    order = np.lexsort((seg_local, inner))
    inner_s = inner[order]
    seg_s = seg_local[order]
    gat_s = gat_local[order]
    bounds = np.searchsorted(inner_s, np.arange(b + 1))
    seg = np.zeros((b, e_cap), dtype=np.int32)
    gat = np.zeros((b, e_cap), dtype=np.int32)
    cnt = np.zeros((b,), dtype=np.int32)
    for k in range(b):
        lo, hi = bounds[k], bounds[k + 1]
        m = hi - lo
        cnt[k] = m
        if m:
            seg[k, :m] = seg_s[lo:hi]
            gat[k, :m] = gat_s[lo:hi]
    return seg, gat, cnt


class EdgeBins:
    """Append-only per-block spill bins for the external binning passes of
    the streaming ingester.  Rows are raw little-endian int64 (src, dst)
    pairs; each bin is read back whole (one bin = one worker's stripe — the
    unit that must individually fit in host memory, O(|M|/b) expected).

    Bin files are opened per write, never held: persistent handles would
    cost 2b fds across the ingester's two bin sets and hit EMFILE near
    b ~ 500 on default ulimits.  Appends are already chunk-batched by the
    caller's stable-sort grouping, so the open/close is amortized.
    """

    def __init__(self, root: str, b: int, tag: str):
        self.root = os.path.join(root, tag)
        os.makedirs(self.root, exist_ok=True)
        self.b = b
        self.rows_appended = np.zeros(b, dtype=np.int64)
        for k in range(b):  # truncate any stale spill from a prior run
            open(self._path(k), "wb").close()

    def _path(self, k: int) -> str:
        return os.path.join(self.root, f"bin{k}.i64")

    def append(self, owner: np.ndarray, edges: np.ndarray) -> None:
        """Append each edge row to its owner's bin, preserving per-bin
        order.  One stable sort groups the chunk by owner (O(chunk log b)
        instead of b full scans — ingest's hot path at large b)."""
        if len(edges) == 0:
            return
        edges = np.ascontiguousarray(edges, dtype="<i8")
        order = np.argsort(owner, kind="stable")
        owner_s = owner[order]
        edges_s = edges[order]
        bounds = np.searchsorted(owner_s, np.arange(self.b + 1))
        for k in range(self.b):
            lo, hi = bounds[k], bounds[k + 1]
            if hi > lo:
                with open(self._path(k), "ab") as f:
                    f.write(np.ascontiguousarray(edges_s[lo:hi]).tobytes())
                self.rows_appended[k] += int(hi - lo)

    def read(self, k: int) -> np.ndarray:
        data = np.fromfile(self._path(k), dtype="<i8")
        return data.reshape(-1, 2).astype(np.int64, copy=False)

    def replace(self, k: int, edges: np.ndarray) -> None:
        """Overwrite bin k (used to persist the per-bin dedup of the
        symmetrize pass before the horizontal re-bin reads it)."""
        np.ascontiguousarray(edges, dtype="<i8").tofile(self._path(k))
        self.rows_appended[k] = edges.shape[0]

    def close(self, *, remove: bool = False) -> None:
        if remove:
            for k in range(self.b):
                if os.path.exists(self._path(k)):
                    os.remove(self._path(k))
            try:
                os.rmdir(self.root)
            except OSError:
                pass
