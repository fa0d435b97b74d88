"""Pre-partitioning (paper §3.1.1) -- done ONCE, reused every iteration.

Partitions the vertex set with ψ into b blocks, derives the b x b sub-matrix
stripes for each placement, and (for PMV_hybrid, §3.5) splits vertices into
sparse / dense regions by the out-degree threshold θ.  All host-side numpy;
the engine moves the resulting arrays to the device once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import blocks as blocks_lib
from repro_torch.core.gimv import GimvSpec
from repro_torch.graph.stats import GraphStats, compute_stats

__all__ = [
    "Partition",
    "PartitionedMatrix",
    "HybridMatrix",
    "partition_graph",
    "edge_weights_for",
    "dense_region_of",
    "build_hybrid",
]


@dataclasses.dataclass(frozen=True)
class Partition:
    """Vertex partitioning function ψ: v -> {0..b-1} plus local index maps.

    ψ='cyclic' (default): block = id % b, local = id // b.
    ψ='range': block = id // n_local (paper Figure 2b's contiguous split).
    """

    n: int
    b: int
    psi: str = "cyclic"

    def __post_init__(self):
        if self.psi not in ("cyclic", "range"):
            raise ValueError(f"psi must be 'cyclic' or 'range', got {self.psi!r}")

    @property
    def n_local(self) -> int:
        return -(-self.n // self.b)  # ceil

    @property
    def n_pad(self) -> int:
        return self.n_local * self.b

    def block_of(self, ids: np.ndarray) -> np.ndarray:
        if self.psi == "cyclic":
            return ids % self.b
        return ids // self.n_local

    def local_of(self, ids: np.ndarray) -> np.ndarray:
        if self.psi == "cyclic":
            return ids // self.b
        return ids % self.n_local

    def global_of(self, block: np.ndarray, local: np.ndarray) -> np.ndarray:
        if self.psi == "cyclic":
            return np.asarray(local) * self.b + np.asarray(block)
        return np.asarray(block) * self.n_local + np.asarray(local)

    def global_ids_grid(self) -> np.ndarray:
        """[b, n_local] global id of every (block, local) slot (pads >= n)."""
        blk = np.arange(self.b)[:, None]
        loc = np.arange(self.n_local)[None, :]
        return self.global_of(blk, loc)

    def to_blocked(self, x: np.ndarray) -> np.ndarray:
        """Global vector [n] (+ any trailing dims) -> blocked [b, n_local]."""
        pad = self.n_pad - self.n
        if pad:
            fill = np.zeros((pad,) + x.shape[1:], dtype=x.dtype)
            x = np.concatenate([x, fill], axis=0)
        if self.psi == "cyclic":
            return x.reshape((self.n_local, self.b) + x.shape[1:]).swapaxes(0, 1)
        return x.reshape((self.b, self.n_local) + x.shape[1:])

    def from_blocked(self, xb: np.ndarray) -> np.ndarray:
        """Blocked [b, n_local] -> global [n] (pads stripped)."""
        xb = np.asarray(xb)
        if self.psi == "cyclic":
            flat = xb.swapaxes(0, 1).reshape((self.n_pad,) + xb.shape[2:])
        else:
            flat = xb.reshape((self.n_pad,) + xb.shape[2:])
        return flat[: self.n]


@dataclasses.dataclass(frozen=True)
class PartitionedMatrix:
    """Pre-partitioned matrix for one basic placement."""

    part: Partition
    stats: GraphStats
    vertical: list          # b stripes: inner axis = dst block i, gat = v^(j) local
    horizontal: list        # b stripes: inner axis = src block jj, gat = v_all[jj]
    block_nnz: np.ndarray   # [b, b] edges in M^(i,j)
    partial_nnz: np.ndarray  # [b, b] structural |v^(i,j)|
    partial_cap: int        # max structural partial size (static exchange cap)


@dataclasses.dataclass(frozen=True)
class HybridMatrix:
    """θ-split matrix for PMV_hybrid: sparse region vertical stripes + dense
    region horizontal stripes + the compacted dense vector map."""

    part: Partition
    stats: GraphStats
    theta: float
    sparse_vertical: list
    dense_horizontal: list
    dense: blocks_lib.DenseRegion
    sparse_partial_nnz: np.ndarray  # [b, b]
    sparse_partial_cap: int
    sparse_nnz: int
    dense_nnz: int


def _edge_weights(spec: GimvSpec, out_deg: np.ndarray, src: np.ndarray, base_w) -> np.ndarray | None:
    if not spec.needs_weights:
        return None
    if spec.edge_weight is None:
        return (np.ones(src.shape, np.float32) if base_w is None else base_w.astype(np.float32))
    w = spec.edge_weight(out_deg[src], base_w)
    if w is None:
        w = np.ones(src.shape, np.float32)
    return w


def edge_weights_for(spec: GimvSpec, out_deg: np.ndarray, src: np.ndarray) -> np.ndarray | None:
    """Per-edge matrix values for sources ``src`` (elementwise, so computing
    them per stripe equals computing them globally then slicing)."""
    return _edge_weights(spec, out_deg, src, None)


def dense_region_of(
    part: Partition, is_dense_vertex: np.ndarray, theta: float
) -> tuple[blocks_lib.DenseRegion, np.ndarray]:
    """Compacted dense-region layout (paper §3.5) from the θ mask.  Returns
    the DenseRegion plus ``slot_of`` [n_pad] mapping each dense vertex's
    global id to its slot in its block's compact row (-1 for sparse)."""
    b = part.b
    dense_ids = np.nonzero(is_dense_vertex)[0]
    dblk = part.block_of(dense_ids)
    dloc = part.local_of(dense_ids)
    order = np.lexsort((dloc, dblk))
    dblk, dloc, dense_ids_sorted = dblk[order], dloc[order], dense_ids[order]
    d_count = np.bincount(dblk, minlength=b).astype(np.int32)
    d_cap = max(int(d_count.max()), 1)
    gather_idx = np.zeros((b, d_cap), dtype=np.int32)
    slot_of = np.full(part.n_pad, -1, dtype=np.int64)
    starts = np.zeros(b + 1, dtype=np.int64)
    np.cumsum(d_count, out=starts[1:])
    for k in range(b):
        lo, hi = starts[k], starts[k + 1]
        gather_idx[k, : hi - lo] = dloc[lo:hi]
        slot_of[dense_ids_sorted[lo:hi]] = np.arange(hi - lo)
    region = blocks_lib.DenseRegion(
        gather_idx=gather_idx, d_count=d_count, d_cap=d_cap, theta=theta)
    return region, slot_of


def partition_graph(
    edges: np.ndarray,
    n: int,
    b: int,
    spec: GimvSpec,
    *,
    psi: str = "cyclic",
    base_weights: np.ndarray | None = None,
    theta: float | None = None,
) -> tuple[PartitionedMatrix, HybridMatrix | None]:
    """Pre-partition: ψ-split the matrix into b x b blocks (+ θ regions).
    Returns the basic-placement stripes always, and the hybrid split when θ
    is given."""
    part = Partition(n=n, b=b, psi=psi)
    stats = compute_stats(edges, n)

    src, dst = edges[:, 0], edges[:, 1]
    w = _edge_weights(spec, stats.out_deg, src, base_weights)

    sb, sl = part.block_of(src), part.local_of(src)
    db, dl = part.block_of(dst), part.local_of(dst)

    vertical, nnz_v = blocks_lib.build_stripes(db, dl, sb, sl, w, b, stripe_axis="gat")
    horizontal, nnz_h = blocks_lib.build_stripes(db, dl, sb, sl, w, b, stripe_axis="seg")
    assert (nnz_v == nnz_h).all()
    partial_nnz = blocks_lib.structural_partial_nnz(db, dl, sb, b)
    pm = PartitionedMatrix(
        part=part, stats=stats, vertical=vertical, horizontal=horizontal,
        block_nnz=nnz_v, partial_nnz=partial_nnz,
        partial_cap=max(int(partial_nnz.max()), 1))

    hm = None
    if theta is not None:
        hm = build_hybrid(part, stats, edges, w, theta)
    return pm, hm


def build_hybrid(
    part: Partition,
    stats: GraphStats,
    edges: np.ndarray,
    w: np.ndarray | None,
    theta: float,
) -> HybridMatrix:
    """θ-split (paper §3.5): source vertices with out-degree >= θ form the
    dense region (executed horizontally); the rest the sparse region
    (executed vertically)."""
    b = part.b
    src, dst = edges[:, 0], edges[:, 1]
    is_dense_vertex = stats.out_deg >= theta

    dense, slot_of = dense_region_of(part, is_dense_vertex, theta)

    edge_dense = is_dense_vertex[src]
    s_src, s_dst = src[~edge_dense], dst[~edge_dense]
    d_src, d_dst = src[edge_dense], dst[edge_dense]
    s_w = None if w is None else w[~edge_dense]
    d_w = None if w is None else w[edge_dense]

    s_sb, s_sl = part.block_of(s_src), part.local_of(s_src)
    s_db, s_dl = part.block_of(s_dst), part.local_of(s_dst)
    sparse_vertical, _ = blocks_lib.build_stripes(s_db, s_dl, s_sb, s_sl, s_w, b, stripe_axis="gat")
    s_partial = (blocks_lib.structural_partial_nnz(s_db, s_dl, s_sb, b)
                 if len(s_src) else np.zeros((b, b), np.int64))

    d_db, d_dl = part.block_of(d_dst), part.local_of(d_dst)
    d_sb = part.block_of(d_src)
    d_slot = slot_of[d_src].astype(np.int64)
    assert (d_slot >= 0).all()
    dense_horizontal, _ = blocks_lib.build_stripes(d_db, d_dl, d_sb, d_slot, d_w, b, stripe_axis="seg")

    return HybridMatrix(
        part=part, stats=stats, theta=theta,
        sparse_vertical=sparse_vertical, dense_horizontal=dense_horizontal,
        dense=dense, sparse_partial_nnz=s_partial,
        sparse_partial_cap=max(int(s_partial.max()), 1),
        sparse_nnz=int(len(s_src)), dense_nnz=int(len(d_src)))
