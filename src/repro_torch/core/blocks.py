"""Block-matrix layouts for pre-partitioned GIM-V (host numpy).

The paper partitions M into b x b sub-matrices M^(i,j).  A *stripe* (the b
blocks co-located on one worker) is stored as arrays of shape [b, E_cap]
padded to the max per-block edge count:

- ``seg_local``: the *segment* (combineAll target) local vertex index -- the
  destination p_local.
- ``gat_local``: the *gather* (combine2 input) local vertex index -- the
  source q_local (or, for hybrid dense regions, the slot into the compacted
  dense vector).
- ``w``: matrix values m_{p,q} (None when the spec never reads them, e.g. CC).
- ``count``: per-block edge counts (mask = arange(E_cap) < count[k]).

Vertical stripe on worker j: leading axis = destination block i, gat_local
indexes the local sub-vector v^(j).  Horizontal stripe on worker i: leading
axis = source block jj, gat_local indexes v^(jj) of the gathered vector.

The dataclasses here are plain frozen containers of numpy arrays (or, once
the engine has placed them, tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.kernels.ell_spmv.ops import ell_from_edges

__all__ = [
    "BlockEdges",
    "build_stripes",
    "structural_partial_nnz",
    "DenseRegion",
    "materialize_dense_matrix",
    "materialize_dense_block",
    "EllBucket",
    "DenseGroup",
    "PlannedStripe",
    "pack_bucketed_ell",
    "pack_planned_stripe",
    "stack_planned",
    "stack_stripes",
    "SEMIRING_FILL_FOLD",
]


@dataclasses.dataclass(frozen=True)
class BlockEdges:
    """One worker's stripe of b edge blocks, padded to a common capacity.
    Stacked across workers (:func:`stack_stripes`) every array gains a
    leading worker axis [b_workers, b, E_cap]."""

    seg_local: Any   # [b, E_cap] int32
    gat_local: Any   # [b, E_cap] int32
    w: Any | None    # [b, E_cap] f32, or None
    count: Any       # [b] int32

    @property
    def e_cap(self) -> int:
        return self.seg_local.shape[-1]


def stack_stripes(stripes: list[BlockEdges]) -> BlockEdges:
    """b per-worker stripes -> one stripe with a leading worker axis."""
    return BlockEdges(
        seg_local=np.stack([s.seg_local for s in stripes]),
        gat_local=np.stack([s.gat_local for s in stripes]),
        w=None if stripes[0].w is None else np.stack([s.w for s in stripes]),
        count=np.stack([s.count for s in stripes]))


def _pad_to(arr: np.ndarray, length: int, fill) -> np.ndarray:
    out = np.full((length,), fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def build_stripes(
    seg_block: np.ndarray,
    seg_local: np.ndarray,
    gat_block: np.ndarray,
    gat_local: np.ndarray,
    w: np.ndarray | None,
    b: int,
    *,
    stripe_axis: str,
) -> tuple[list[BlockEdges], np.ndarray]:
    """Group edges into per-worker stripes of per-block padded arrays.

    stripe_axis='gat': vertical placement -- worker owns all edges whose
      source (gather side) lives in its block; the inner block axis is the
      destination block.
    stripe_axis='seg': horizontal placement -- worker owns all edges whose
      destination lives in its block; the inner block axis is the source block.

    Returns (stripes[worker], block_nnz[i, j]) with block_nnz[i, j] = edges in
    sub-matrix M^(i,j) (i = seg block, j = gat block).
    """
    assert stripe_axis in ("gat", "seg")
    owner = gat_block if stripe_axis == "gat" else seg_block
    inner = seg_block if stripe_axis == "gat" else gat_block

    pair = owner.astype(np.int64) * b + inner.astype(np.int64)
    counts2d = np.bincount(pair, minlength=b * b).reshape(b, b)  # [owner, inner]
    e_cap = max(int(counts2d.max()), 1)

    # Sort edges by (owner, inner, seg_local) so segment ids are sorted
    # within each block.
    order = np.lexsort((seg_local, inner, owner))
    seg_local = seg_local[order]
    gat_local = gat_local[order]
    ww = None if w is None else w[order]
    owner_s = owner[order]
    inner_s = inner[order]
    boundaries = np.searchsorted(owner_s * b + inner_s, np.arange(b * b + 1))

    stripes: list[BlockEdges] = []
    for j in range(b):
        seg_blocks = np.zeros((b, e_cap), dtype=np.int32)
        gat_blocks = np.zeros((b, e_cap), dtype=np.int32)
        w_blocks = None if w is None else np.zeros((b, e_cap), dtype=w.dtype)
        cnt = np.zeros((b,), dtype=np.int32)
        for i in range(b):
            lo, hi = boundaries[j * b + i], boundaries[j * b + i + 1]
            m = hi - lo
            cnt[i] = m
            if m:
                seg_blocks[i, :m] = seg_local[lo:hi]
                gat_blocks[i, :m] = gat_local[lo:hi]
                if w_blocks is not None:
                    w_blocks[i, :m] = ww[lo:hi]
        stripes.append(BlockEdges(seg_blocks, gat_blocks, w_blocks, cnt))

    block_nnz = counts2d.T if stripe_axis == "gat" else counts2d
    return stripes, block_nnz


def structural_partial_nnz(
    seg_block: np.ndarray, seg_local: np.ndarray, gat_block: np.ndarray, b: int
) -> np.ndarray:
    """nnz_struct[i, j] = |{distinct p_local : (p, q) in M^(i,j)}|: the exact
    structural size of the partial vector v^(i,j) (paper Eq. 4 estimates its
    expectation); it sizes the sparse exchange so overflow never occurs."""
    width = int(seg_local.max(initial=0)) + 1
    key = (seg_block.astype(np.int64) * b + gat_block.astype(np.int64)) * width \
        + seg_local.astype(np.int64)
    uniq = np.unique(key)
    counts = np.bincount(uniq // width, minlength=b * b)
    return counts.reshape(b, b)


# Semiring fill value (no-op under combineAll) and the fold used when
# parallel edges land on the same dense cell -- matching segment_combine on
# the edge list.  min_src stores a presence matrix (fill 0, fold max).
SEMIRING_FILL_FOLD = {
    "plus_times": (0.0, np.add),
    "min_plus": (np.inf, np.minimum),
    "max_plus": (-np.inf, np.maximum),
    "min_src": (0.0, np.maximum),
}


def materialize_dense_matrix(
    stripe: BlockEdges, n_local: int, d_cap: int, semiring: str
) -> np.ndarray:
    """Dense-region horizontal stripe -> a [n_local, b * d_cap] dense matrix
    for the dense GIM-V kernel.  Column jj * d_cap + slot holds the combine2
    weight of the edge from dense slot ``slot`` of block jj; absent entries
    hold the semiring's fill value, parallel edges fold with its combine."""
    b, _ = stripe.seg_local.shape
    counts = np.asarray(stripe.count)
    fill, fold = SEMIRING_FILL_FOLD[semiring]
    m = np.full((n_local, b * d_cap), fill, dtype=np.float32)
    for jj in range(b):
        cnt = int(counts[jj])
        if not cnt:
            continue
        rows = np.asarray(stripe.seg_local[jj, :cnt])
        cols = jj * d_cap + np.asarray(stripe.gat_local[jj, :cnt]).astype(np.int64)
        if stripe.w is not None and semiring != "min_src":
            vals = np.asarray(stripe.w[jj, :cnt], dtype=np.float32)
        else:
            vals = np.ones(cnt, dtype=np.float32)
        fold.at(m, (rows, cols), vals)
    return m


@dataclasses.dataclass(frozen=True)
class DenseRegion:
    """Compacted high-out-degree ("dense", paper §3.5) vector region: dense
    vertices of block k occupy slots [0, d_count[k]) of row k."""

    gather_idx: Any   # [b, d_cap] int32 -- local index of each dense vertex
    d_count: Any      # [b] int32
    d_cap: int
    theta: float


# ---------------------------------------------------------------------------
# Planned packing (planner.ExecutionPlan -> layouts).  A worker's stripe
# splits into: skip (structurally empty, dropped), ell (ROW-BUCKETED ELL:
# destination rows grouped by degree into power-of-two width buckets) and
# dense (near-dense blocks materialized as [n_local, n_local] matrices).
# Rows carry their flat output index so same-tactic blocks of a stripe fuse
# into per-bucket kernel launches.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One degree-bucket ELL slice covering all ell-tactic blocks of a stripe.

    rows: [R] int32 flat output row of each table row (-1 = stacking pad);
    cols: [R, D] int32 gather index (-1 = pad slot); w: [R, D] or None.
    Every destination row lives in exactly one bucket, so bucket results
    scatter with a plain set."""

    rows: Any        # [(b_w,) R] int32; -1 = pad
    cols: Any        # [(b_w,) R, D] int32; -1 = pad
    w: Any | None

    @property
    def d_cap(self) -> int:
        return self.cols.shape[-1]


@dataclasses.dataclass(frozen=True)
class DenseGroup:
    """The dense-tactic blocks of a stripe, fused for one dense launch.

    layout='vertical': matrix [k, n_local, n_local], index [k] destination
      block ids (-1 = stacking pad, identity-filled, dropped at scatter).
    layout='merged': matrix [n_local, k * n_local], index [k] source block ids
      (stacking pads use index 0; their columns are identity-filled).
    """

    matrix: Any
    index: Any       # [(b_w,) k] int32


@dataclasses.dataclass(frozen=True)
class PlannedStripe:
    """One worker's plan-packed stripe: bucketed ELL slices + dense group.

    layout='vertical': output space is the flat partial vector [b * n_local];
    cols index the worker-local source vector [n_local].
    layout='merged' (horizontal): output space is the worker's result
    [n_local]; cols are pre-offset to jj * n_local + gat_local, indexing the
    flat gathered vector [b * n_local].
    """

    buckets: tuple   # tuple[EllBucket, ...]
    dense: DenseGroup | None
    rows_out: int
    layout: str


def pack_bucketed_ell(
    out_rows: np.ndarray,
    cols: np.ndarray,
    w: np.ndarray | None,
    boundaries: tuple[int, ...],
) -> tuple:
    """Flat edge arrays -> row-bucketed ELL slices.  An output row of degree
    d goes to the first bucket whose width boundary >= d; every bucket is
    emitted (possibly with R_k = 0) so all workers share one structure."""
    out_rows = np.asarray(out_rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    bounds = np.asarray(boundaries, dtype=np.int64)
    if out_rows.size:
        deg = np.bincount(out_rows)
        present = np.nonzero(deg)[0]
        assert int(deg.max()) <= int(bounds[-1]), (int(deg.max()), boundaries)
        bucket_of = np.searchsorted(bounds, deg[present], side="left")
        remap = np.full(int(out_rows.max()) + 1, -1, dtype=np.int64)
    else:
        present = np.zeros(0, dtype=np.int64)
        bucket_of = np.zeros(0, dtype=np.int64)
        remap = np.zeros(0, dtype=np.int64)

    has_w = w is not None
    buckets = []
    for k, cap_k in enumerate(boundaries):
        rows_k = present[bucket_of == k]
        if rows_k.size == 0:
            buckets.append(EllBucket(
                rows=np.zeros((0,), np.int32),
                cols=np.full((0, cap_k), -1, np.int32),
                w=np.zeros((0, cap_k), np.float32) if has_w else None))
            continue
        remap[:] = -1
        remap[rows_k] = np.arange(rows_k.size)
        sel = remap[out_rows] >= 0
        cols_k, w_k = ell_from_edges(
            remap[out_rows[sel]], cols[sel],
            np.asarray(w)[sel] if has_w else None,
            rows_k.size, d_cap=cap_k)
        buckets.append(EllBucket(rows=rows_k.astype(np.int32), cols=cols_k, w=w_k))
    return tuple(buckets)


def materialize_dense_block(
    dst: np.ndarray, src: np.ndarray, w: np.ndarray | None, n_local: int, semiring: str
) -> np.ndarray:
    """One dense-tactic block's edges -> a [n_local, n_local] semiring matrix
    (fill = combineAll identity / presence 0; parallel edges fold)."""
    fill, fold = SEMIRING_FILL_FOLD[semiring]
    m = np.full((n_local, n_local), fill, dtype=np.float32)
    if w is not None and semiring != "min_src":
        vals = np.asarray(w, dtype=np.float32)
    else:
        vals = np.ones(len(dst), dtype=np.float32)
    fold.at(m, (np.asarray(dst), np.asarray(src)), vals)
    return m


def pack_planned_stripe(
    stripe: BlockEdges,
    tactics: tuple[str, ...],
    n_local: int,
    *,
    layout: str,
    boundaries: tuple[int, ...],
    semiring: str,
) -> PlannedStripe:
    """Pack one worker's stripe against its per-block tactics; tactics[k] is
    the tactic of the k-th inner block."""
    assert layout in ("vertical", "merged"), layout
    b = stripe.seg_local.shape[0]
    counts = np.asarray(stripe.count)
    has_w = stripe.w is not None

    out_rows_l: list[np.ndarray] = []
    cols_l: list[np.ndarray] = []
    w_l: list[np.ndarray] = []
    dense_mats: list[np.ndarray] = []
    dense_index: list[int] = []
    for k in range(b):
        cnt = int(counts[k])
        if tactics[k] == "skip" or cnt == 0:
            continue
        seg = np.asarray(stripe.seg_local[k, :cnt], dtype=np.int64)
        gat = np.asarray(stripe.gat_local[k, :cnt], dtype=np.int64)
        wk = np.asarray(stripe.w[k, :cnt]) if has_w else None
        if tactics[k] == "ell":
            if layout == "vertical":
                out_rows_l.append(k * n_local + seg)
                cols_l.append(gat)
            else:
                out_rows_l.append(seg)
                cols_l.append(k * n_local + gat)
            if has_w:
                w_l.append(wk)
        else:  # dense
            dense_mats.append(materialize_dense_block(seg, gat, wk, n_local, semiring))
            dense_index.append(k)

    def cat(xs, dt):
        return np.concatenate(xs) if xs else np.zeros(0, dt)

    buckets = pack_bucketed_ell(
        cat(out_rows_l, np.int64), cat(cols_l, np.int64),
        cat(w_l, np.float32) if has_w else None, boundaries)

    dense = None
    if dense_mats:
        if layout == "vertical":
            dense = DenseGroup(matrix=np.stack(dense_mats),
                               index=np.asarray(dense_index, np.int32))
        else:
            dense = DenseGroup(matrix=np.concatenate(dense_mats, axis=1),
                               index=np.asarray(dense_index, np.int32))
    rows_out = b * n_local if layout == "vertical" else n_local
    return PlannedStripe(buckets=buckets, dense=dense, rows_out=rows_out, layout=layout)


def _dense_nl(stripes: list[PlannedStripe]) -> int:
    for s in stripes:
        if s.dense is not None:
            return s.dense.matrix.shape[-1]
    raise AssertionError("no dense group on any worker")


def stack_planned(stripes: list[PlannedStripe], semiring: str) -> PlannedStripe:
    """b per-worker planned stripes -> one stripe with a leading worker axis.

    Buckets share widths, so only the row counts pad (rows = -1, cols = -1);
    buckets empty on EVERY worker are dropped.  Dense groups pad to the max
    dense-block count with identity-filled matrices (index -1 for
    'vertical', index 0 for 'merged')."""
    layout = stripes[0].layout
    n_buckets = len(stripes[0].buckets)
    fill, _ = SEMIRING_FILL_FOLD[semiring]

    out_buckets = []
    for k in range(n_buckets):
        bs = [s.buckets[k] for s in stripes]
        r_max = max(x.rows.shape[0] for x in bs)
        if r_max == 0:
            continue
        d = bs[0].cols.shape[-1]
        has_w = bs[0].w is not None
        rows = np.stack([_pad_to(x.rows, r_max, -1) for x in bs])
        cols = np.stack([
            np.concatenate([x.cols, np.full((r_max - x.rows.shape[0], d), -1, np.int32)])
            for x in bs])
        w = None
        if has_w:
            w = np.stack([
                np.concatenate([x.w, np.zeros((r_max - x.rows.shape[0], d), np.float32)])
                for x in bs])
        out_buckets.append(EllBucket(rows=rows, cols=cols, w=w))

    k_max = max((0 if s.dense is None else s.dense.index.shape[0]) for s in stripes)
    dense = None
    if k_max:
        mats, idxs = [], []
        for s in stripes:
            k_s = 0 if s.dense is None else s.dense.index.shape[0]
            idx = s.dense.index if k_s else np.zeros(0, np.int32)
            if layout == "vertical":
                nl = _dense_nl(stripes)
                m = s.dense.matrix if k_s else np.zeros((0, nl, nl), np.float32)
                pad = np.full((k_max - k_s, nl, nl), fill, np.float32)
                mats.append(np.concatenate([m, pad]) if k_max - k_s else m)
                idxs.append(_pad_to(idx, k_max, -1))
            else:
                nl = s.rows_out
                m = s.dense.matrix if k_s else np.zeros((nl, 0), np.float32)
                pad = np.full((nl, (k_max - k_s) * nl), fill, np.float32)
                mats.append(np.concatenate([m, pad], axis=1) if k_max - k_s else m)
                idxs.append(_pad_to(idx, k_max, 0))
        dense = DenseGroup(matrix=np.stack(mats), index=np.stack(idxs))
    return PlannedStripe(buckets=tuple(out_buckets), dense=dense,
                         rows_out=stripes[0].rows_out, layout=layout)
