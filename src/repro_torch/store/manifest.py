"""Versioned manifest + loaders for the on-disk pre-partitioned block store
(this package's counterpart of the JAX package's ``repro.store.manifest``,
on ``repro_torch.core``; it reads the stores either package writes).

The manifest is a small JSON document describing one pre-partitioning (ψ, b,
E_cap, degree/offset array shapes, ingest provenance); the payloads live in
memmap-able ``.npy`` shards (format.py).  Loading is bitwise-faithful:
``load_partitioned(manifest, spec)`` reconstructs exactly the
``PartitionedMatrix`` / ``HybridMatrix`` that ``partition_graph`` builds in
memory — matrix values are recomputed per spec from the stored out-degrees
(partition.edge_weights_for), and the hybrid θ-split is rebuilt from the
vertical shards (edge order within every (owner, inner, seg_local) group is
preserved by the binning passes, which is the only order the packers see).

``plan_from_manifest`` rebuilds the per-block ExecutionPlan from the
persisted measurements (nnz / rows / d_max / pow2 degree histograms) without
touching the shards — the disk-residency executor plans against it before
fetching a single edge.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.core import planner
from repro_torch.core.blocks import BlockEdges
from repro_torch.core.partition import (
    HybridMatrix,
    Partition,
    PartitionedMatrix,
    build_hybrid,
    edge_weights_for,
)
from repro_torch.graph.stats import GraphStats
from repro_torch.store import format as fmt

__all__ = [
    "Manifest",
    "ManifestCorruptError",
    "ManifestVersionError",
    "ShardCorruptError",
    "open_store",
    "load_partitioned",
    "plan_from_manifest",
    "row_weights",
    "row_weights_dense",
]

MANIFEST_FILE = "manifest.json"


class ManifestCorruptError(RuntimeError):
    """manifest.json exists but cannot be parsed (truncated / invalid JSON /
    missing required keys).  Carries the path and, for parse failures, the
    exact parse position."""

    def __init__(self, path: str, msg: str, *, pos: int | None = None,
                 lineno: int | None = None, colno: int | None = None):
        self.path = path
        self.pos = pos
        self.lineno = lineno
        self.colno = colno
        where = (f" at line {lineno} column {colno} (char {pos})"
                 if pos is not None else "")
        super().__init__(f"{path}: corrupt manifest{where}: {msg} — "
                         "re-ingest the store (repro_torch.store.ingest_edges)")


class ManifestVersionError(RuntimeError):
    """The store's format version lacks a feature this run requires (e.g. a
    v1 store has no packed-exchange index shards).  Raised at prepare() time
    with the exact versions and the fix, instead of a shape/missing-file
    error deep inside the first fetch."""

    def __init__(self, path: str, *, found: int, needed: int, feature: str):
        self.path = path
        self.found = found
        self.needed = needed
        self.feature = feature
        super().__init__(
            f"{path}: store format version {found} predates {feature} "
            f"(needs version >= {needed}) — re-ingest the store with "
            "repro_torch.store.ingest_edges, or run with exchange='sparse'")


class ShardCorruptError(RuntimeError):
    """A shard read failed checksum verification.  Carries a precise
    diagnosis: which file, which worker/block row, expected vs actual digest.
    Transient corruption (a flipped bit in flight) recovers via re-fetch
    (repro_torch.faults.RetryPolicy); persistent corruption keeps failing with the
    same diagnosis — re-ingest or restore the shard."""

    def __init__(self, path: str, *, array: str, worker: int | None = None,
                 block: int | None = None, expected: str = "?", actual: str = "?"):
        self.path = path
        self.array = array
        self.worker = worker
        self.block = block
        self.expected = expected
        self.actual = actual
        where = f"array {array!r}"
        if worker is not None:
            where += f", worker {worker}"
        if block is not None:
            where += f", block row {block}"
        super().__init__(
            f"{path}: checksum mismatch ({where}): expected {expected}, "
            f"read {actual} — shard corrupted on disk or in flight")


@dataclasses.dataclass
class Manifest:
    """Metadata of one ingested store directory (see module docstring)."""

    root: str
    n: int
    m: int
    b: int
    psi: str
    symmetrized: bool
    e_cap: int
    partial_cap: int
    ingest: dict
    version: int = fmt.FORMAT_VERSION
    # integrity digests; None for pre-checksum stores, else
    #   {"algorithm": "crc32c"|"crc32",
    #    "arrays":  {name: digest}                       whole-array digests
    #    "stripes": {striping: [per-worker {"seg": [b row digests],
    #                                       "gat": [...], "cnt": digest}]}}
    checksums: dict | None = None
    # θ-split hybrid shards (sparse_vertical / dense_horizontal stripings);
    # None when the store was ingested without theta=.  Holds
    #   {"theta": float, "sparse_e_cap": int, "dense_e_cap": int,
    #    "sparse_partial_cap": int, "d_cap": int,
    #    "sparse_m": int, "dense_m": int}
    # — everything else (gather index, slot map) is recomputed
    # deterministically from out_deg >= theta at load time.
    hybrid: dict | None = None
    # Per-host manifest partitioning: None for a whole store; a shard
    # manifest carries {"count": W, "worker": w, "lo": int, "hi": int} —
    # mesh worker w of W owns the stripe files of global workers [lo, hi).
    worker_shard: dict | None = None

    # ------------------------------------------------------------------
    def save(self) -> None:
        doc = {
            "format": fmt.FORMAT_NAME,
            "version": self.version,
            "n": self.n, "m": self.m, "b": self.b, "psi": self.psi,
            "symmetrized": self.symmetrized,
            "e_cap": self.e_cap, "partial_cap": self.partial_cap,
            "ingest": self.ingest,
        }
        if self.checksums is not None:
            doc["checksums"] = self.checksums
        if self.hybrid is not None:
            doc["hybrid"] = self.hybrid
        # absent (not null) when whole, so a split -> merge round trip
        # reproduces the original manifest.json byte-for-byte
        if self.worker_shard is not None:
            doc["worker_shard"] = self.worker_shard
        tmp = os.path.join(self.root, MANIFEST_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(self.root, MANIFEST_FILE))  # atomic

    @classmethod
    def load(cls, root: str) -> "Manifest":
        path = os.path.join(root, MANIFEST_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no {MANIFEST_FILE} under {root!r} — not a block-store "
                "directory (create one with repro_torch.store.ingest_edges)")
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                # a truncated or garbled manifest is a CORRUPTION diagnosis,
                # not a parse traceback: typed, with the exact position
                raise ManifestCorruptError(
                    path, e.msg, pos=e.pos, lineno=e.lineno, colno=e.colno,
                ) from e
        if not isinstance(doc, dict):
            raise ManifestCorruptError(
                path, f"expected a JSON object, got {type(doc).__name__}")
        if doc.get("format") != fmt.FORMAT_NAME:
            raise ValueError(
                f"{path}: format {doc.get('format')!r} is not "
                f"{fmt.FORMAT_NAME!r}")
        if int(doc.get("version", -1)) > fmt.FORMAT_VERSION:
            raise ValueError(
                f"{path}: store version {doc.get('version')} is newer than "
                f"this reader (supports <= {fmt.FORMAT_VERSION}) — upgrade "
                "repro_torch or re-ingest")
        try:
            return cls(root=root, n=int(doc["n"]), m=int(doc["m"]),
                       b=int(doc["b"]), psi=doc["psi"],
                       symmetrized=bool(doc["symmetrized"]),
                       e_cap=int(doc["e_cap"]),
                       partial_cap=int(doc["partial_cap"]),
                       ingest=doc.get("ingest", {}),
                       version=int(doc.get("version", fmt.FORMAT_VERSION)),
                       checksums=doc.get("checksums"),
                       hybrid=doc.get("hybrid"),
                       worker_shard=doc.get("worker_shard"))
        except (KeyError, TypeError, ValueError) as e:
            raise ManifestCorruptError(
                path, f"missing or malformed required field ({e!r})") from e

    # ------------------------------------------------------------------
    @property
    def part(self) -> Partition:
        return Partition(n=self.n, b=self.b, psi=self.psi)

    # -- per-host shards / hybrid stripings ----------------------------
    def stripings(self) -> tuple[str, ...]:
        """The stripings this store carries shard files for."""
        basic = ("vertical", "horizontal")
        if self.hybrid is not None:
            return basic + ("sparse_vertical", "dense_horizontal")
        return basic

    def e_cap_of(self, striping: str) -> int:
        """Padded edge capacity of one striping's stripe rows."""
        if striping == "sparse_vertical":
            return int(self.hybrid["sparse_e_cap"])
        if striping == "dense_horizontal":
            return int(self.hybrid["dense_e_cap"])
        return self.e_cap

    def owned_workers(self, *, default=None):
        """Global worker (stripe file) ids this manifest owns: everything
        for a whole store (or ``default`` when given), the [lo, hi) range
        for a per-host shard manifest."""
        if self.worker_shard is not None:
            return range(int(self.worker_shard["lo"]),
                         int(self.worker_shard["hi"]))
        return range(self.b) if default is None else default

    def worker_shard_view(self, worker: int, count: int) -> "Manifest":
        """A VIRTUAL per-host shard over the same store directory: worker
        ``worker`` of ``count`` owns the contiguous stripe range
        [worker*b/count, (worker+1)*b/count).  No bytes move — this is how
        the SPMD disk engine scopes each mesh worker to its own shard
        without physically splitting the store (shard.split_store does the
        physical split)."""
        if count <= 0 or self.b % count != 0:
            raise ValueError(
                f"cannot shard b={self.b} stripes across {count} workers "
                "(count must divide b)")
        if not 0 <= worker < count:
            raise ValueError(f"worker {worker} out of range for {count}")
        stride = self.b // count
        view = dataclasses.replace(
            self, worker_shard={"count": int(count), "worker": int(worker),
                                "lo": worker * stride,
                                "hi": (worker + 1) * stride})
        return view

    def hybrid_theta(self) -> float:
        if self.hybrid is None:
            raise ValueError(
                "store has no θ-split hybrid shards — re-ingest with "
                "ingest_edges(..., theta=...) to cover strategy='hybrid' "
                "under residency='disk'")
        return float(self.hybrid["theta"])

    def dense_region(self):
        """(DenseRegion, slot_of) of the hybrid shards, recomputed
        deterministically from the stored out-degrees and θ — bitwise what
        ``build_hybrid`` computes on the original edge list."""
        from repro_torch.core.partition import dense_region_of

        theta = self.hybrid_theta()
        out_deg = np.asarray(self.array("out_deg"))
        return dense_region_of(self.part, out_deg >= theta, theta)

    def array(self, name: str, *, mmap: bool = False) -> np.ndarray:
        return fmt.open_array(fmt.array_path(self.root, name), mmap=mmap)

    def graph_stats(self) -> GraphStats:
        return GraphStats(
            n=self.n, n_edges=self.m,
            out_deg=np.asarray(self.array("out_deg")),
            in_deg=np.asarray(self.array("in_deg")),
            density=float(self.m) / float(self.n) ** 2,
        )

    def stripe_arrays(self, striping: str, worker: int, *, mmap: bool = False):
        """(seg, gat, cnt) of one worker's stripe shard."""
        return tuple(
            fmt.open_array(fmt.stripe_path(self.root, striping, worker, a),
                           mmap=mmap)
            for a in fmt.STRIPE_ARRAYS)

    def total_shard_bytes(self, striping: str) -> int:
        """On-disk bytes of one striping's shard files (the block set a
        disk-residency budget is compared against)."""
        total = 0
        for w in range(self.b):
            for a in fmt.STRIPE_ARRAYS:
                total += os.path.getsize(fmt.stripe_path(self.root, striping, w, a))
        return total

    def measured_records(self) -> list[dict]:
        """Per-block planner measurement records (planner.plan_from_stats
        input) reconstructed from the persisted arrays — b*b dicts,
        row-major (i, j), classifying bitwise like measure_blocks."""
        nnz = np.asarray(self.array("nnz"))
        rows = np.asarray(self.array("rows"))
        d_max = np.asarray(self.array("d_max"))
        hist = np.asarray(self.array("deg_hist"))
        out = []
        for i in range(self.b):
            for j in range(self.b):
                out.append({"nnz": int(nnz[i, j]), "rows": int(rows[i, j]),
                            "d_max": int(d_max[i, j]),
                            "deg_hist": hist[i, j]})
        return out

    def merged_d_max(self) -> int:
        """Horizontal merged-layout bucket bound: the max full per-row
        in-degree (== max in_deg — a destination row's merged ELL slots span
        every source block)."""
        in_deg = np.asarray(self.array("in_deg"))
        return max(int(in_deg.max(initial=0)), 1)

    # -- integrity -----------------------------------------------------
    @property
    def checksum_algorithm(self) -> str | None:
        return self.checksums.get("algorithm") if self.checksums else None

    def stripe_checksums(self, striping: str, worker: int) -> dict | None:
        """{"seg": [b row digests], "gat": [...], "cnt": digest} for one
        worker's stripe shard, or None for a pre-checksum store."""
        if not self.checksums:
            return None
        per_striping = self.checksums.get("stripes", {}).get(striping)
        if per_striping is None:
            return None
        return per_striping[worker]

    def verify_array(self, name: str) -> None:
        """Whole-array digest check for a stats/blocks array; raises
        :class:`ShardCorruptError` on mismatch, no-op without checksums."""
        if not self.checksums:
            return
        expected = self.checksums.get("arrays", {}).get(name)
        if expected is None:
            return
        actual = fmt.checksum_array(np.asarray(self.array(name)),
                                    self.checksum_algorithm)
        if actual != expected:
            raise ShardCorruptError(fmt.array_path(self.root, name),
                                    array=name, expected=expected,
                                    actual=actual)

    # -- packed exchange (format v2) -----------------------------------
    @property
    def has_packed_index(self) -> bool:
        return self.version >= 2

    def require_packed_index(self) -> None:
        """Raise :class:`ManifestVersionError` when this store predates the
        packed-exchange index shards (format v1)."""
        if not self.has_packed_index:
            raise ManifestVersionError(
                os.path.join(self.root, MANIFEST_FILE), found=self.version,
                needed=2, feature="the packed-exchange index shards")

    def packed_index_arrays(self, worker: int) -> tuple[np.ndarray, np.ndarray]:
        """(words uint32, meta [b, 3] int64) of one vertical worker's packed
        index shard, checksum-verified when the manifest carries digests."""
        self.require_packed_index()
        words = np.asarray(
            fmt.open_array(fmt.pidx_path(self.root, worker, "words")))
        meta = np.asarray(
            fmt.open_array(fmt.pidx_path(self.root, worker, "meta")))
        sums = (self.checksums or {}).get("pidx")
        if sums:
            algo = self.checksum_algorithm
            for name, arr in (("words", words), ("meta", meta)):
                expected = sums[worker][name]
                actual = fmt.checksum_array(arr, algo)
                if actual != expected:
                    raise ShardCorruptError(
                        fmt.pidx_path(self.root, worker, name),
                        array=f"pidx.{name}", worker=worker,
                        expected=expected, actual=actual)
        return words, meta

    def packed_row_sets(self) -> list:
        """``rows[i][j]`` sorted unique destination-local ids decoded from
        the v2 packed index shards — ``exchange.plan.build_exchange``'s
        input, derived without touching the edge shards."""
        from repro_torch.exchange import codec as xcodec

        b = self.b
        rows = [[None] * b for _ in range(b)]
        for j in range(b):
            words, meta = self.packed_index_arrays(j)
            for i in range(b):
                off, count, width = (int(x) for x in meta[i])
                n_words = -(-count * width // 32)
                rows[i][j] = xcodec.unpack_fields(
                    words[off: off + n_words], count, width)
        return rows


def open_store(store) -> Manifest:
    """Path or Manifest -> Manifest."""
    if isinstance(store, Manifest):
        return store
    return Manifest.load(os.fspath(store))


# ---------------------------------------------------------------------------
# Bitwise loaders.
# ---------------------------------------------------------------------------

def row_weights(spec, part: Partition, src_block: int, gat_row: np.ndarray,
                cnt: int, out_deg: np.ndarray) -> np.ndarray:
    """Recompute one block row's BlockEdges.w slots ([e_cap] f32, zeros past
    ``cnt``).  The source global id of every edge is recoverable from its
    stripe coordinates (vertical worker j: src block == j; horizontal inner
    k: src block == k), so weights need no storage.  This is the ONE site
    of the bitwise-critical weight reconstruction — the full-stripe loader
    and the disk-residency fetcher both call it."""
    w = np.zeros(gat_row.shape, dtype=np.float32)
    c = int(cnt)
    if c:
        src = part.global_of(src_block, gat_row[:c].astype(np.int64))
        w[:c] = edge_weights_for(spec, out_deg, src)
    return w


def row_weights_dense(spec, part: Partition, src_block: int,
                      gat_row: np.ndarray, cnt: int, out_deg: np.ndarray,
                      gather_idx: np.ndarray) -> np.ndarray:
    """``row_weights`` for a dense_horizontal stripe row, whose gather column
    holds compact dense-region SLOTS instead of local ids: the slot resolves
    to the source's local id through ``gather_idx[src_block]`` (the
    dense-region layout, recomputed from out_deg >= θ), then to the global
    id exactly as the basic path does."""
    w = np.zeros(gat_row.shape, dtype=np.float32)
    c = int(cnt)
    if c:
        local = np.asarray(gather_idx[src_block])[
            gat_row[:c].astype(np.int64)].astype(np.int64)
        src = part.global_of(src_block, local)
        w[:c] = edge_weights_for(spec, out_deg, src)
    return w


def _stripe_weights(spec, part: Partition, striping: str, worker: int,
                    gat: np.ndarray, cnt: np.ndarray, out_deg: np.ndarray):
    """Recompute BlockEdges.w for one loaded stripe (see row_weights)."""
    if not spec.needs_weights:
        return None
    b = gat.shape[0]
    return np.stack([
        row_weights(spec, part,
                    worker if striping == "vertical" else k,
                    gat[k], cnt[k], out_deg)
        for k in range(b)])


def load_stripe(manifest: Manifest, striping: str, worker: int, spec,
                out_deg: np.ndarray) -> BlockEdges:
    seg, gat, cnt = manifest.stripe_arrays(striping, worker)
    seg = np.asarray(seg)
    gat = np.asarray(gat)
    cnt = np.asarray(cnt)
    w = _stripe_weights(spec, manifest.part, striping, worker, gat, cnt, out_deg)
    return BlockEdges(seg, gat, w, cnt)


def _reconstruct_edges(part: Partition, vertical: list[BlockEdges]):
    """Flat (src, dst) arrays from the vertical shards.  The order differs
    from the original stream globally, but matches it within every
    (owner, inner, seg_local) group — the only order build_stripes /
    build_hybrid's stable sorts can observe — so downstream packing is
    bitwise identical."""
    srcs, dsts = [], []
    for j, st in enumerate(vertical):
        cnt = np.asarray(st.count)
        for i in range(part.b):
            c = int(cnt[i])
            if not c:
                continue
            srcs.append(part.global_of(j, np.asarray(st.gat_local[i, :c], np.int64)))
            dsts.append(part.global_of(i, np.asarray(st.seg_local[i, :c], np.int64)))
    if not srcs:
        return np.zeros((0, 2), dtype=np.int64)
    return np.stack([np.concatenate(srcs), np.concatenate(dsts)], axis=1)


def load_partitioned(
    store, spec, *, theta: float | None = None
) -> tuple[PartitionedMatrix, HybridMatrix | None]:
    """Store -> (PartitionedMatrix, HybridMatrix | None), bitwise equal to
    ``partition_graph(edges, n, b, spec, psi=psi, theta=theta)`` on the
    ingested edge list (post-symmetrize when the store was ingested with
    ``symmetrize=True``)."""
    manifest = open_store(store)
    part = manifest.part
    stats = manifest.graph_stats()
    out_deg = stats.out_deg
    vertical = [load_stripe(manifest, "vertical", j, spec, out_deg)
                for j in range(manifest.b)]
    horizontal = [load_stripe(manifest, "horizontal", i, spec, out_deg)
                  for i in range(manifest.b)]
    partial_nnz = np.asarray(manifest.array("partial_nnz"))
    pm = PartitionedMatrix(
        part=part, stats=stats, vertical=vertical, horizontal=horizontal,
        block_nnz=np.asarray(manifest.array("nnz")),
        partial_nnz=partial_nnz,
        partial_cap=max(int(partial_nnz.max()), 1),
    )
    hm = None
    if theta is not None:
        edges = _reconstruct_edges(part, vertical)
        w = edge_weights_for(spec, out_deg, edges[:, 0]) if spec.needs_weights else None
        hm = build_hybrid(part, stats, edges, w, theta)
    return pm, hm


def plan_from_manifest(
    store,
    *,
    strategy: str,
    mode: str = "torch",
    theta: float | None = None,
    capacity: int | None = None,
    scatter: str = "auto",
    stream: str = "off",
    interpret: bool = False,
    residency: str = "disk",
) -> planner.ExecutionPlan:
    """ExecutionPlan from the manifest's persisted per-block measurements —
    no shard I/O.  Equals ``plan_execution`` on the loaded matrix for the
    basic strategies ('hybrid' plans depend on the θ-split stripes, which
    only exist after a full load)."""
    manifest = open_store(store)
    if strategy == "hybrid":
        raise NotImplementedError(
            "plan_from_manifest covers the basic strategies; load the store "
            "(load_partitioned) and use plan_execution for hybrid plans")
    return planner.plan_from_stats(
        manifest.measured_records(), b=manifest.b,
        n_local=manifest.part.n_local, strategy=strategy, mode=mode,
        theta=theta, capacity=capacity, scatter=scatter, stream=stream,
        interpret=interpret, residency=residency,
        merged_d_max=(manifest.merged_d_max() if strategy == "horizontal"
                      else None))
