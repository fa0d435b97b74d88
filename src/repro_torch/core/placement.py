"""PMV placement strategies (paper §3.2-3.5).

Every per-worker array carries a leading worker axis.  In emulation (no
worker ``axis``) it holds all b workers on one device: the all-gather of the
horizontal placement is the blocked vector itself and the all-to-all of the
vertical placement a transpose of the first two axes.  Under a worker axis
(``collectives.WorkerAxis``, one rank per worker) it has length 1 on each
rank and the same bodies run, with the collectives of ``core/collectives.py``
moving the bytes between the ranks.

- PMV_horizontal (Alg. 1): gather the whole vector, compute the local stripe.
- PMV_vertical   (Alg. 2): local column-stripe partials v^(i,j), exchanged
  dense ([b, n_local]), compacted to (idx, val) pairs (sparse_exchange.py),
  packed: gathered at the static per-pair row sets that prepare derived
  once, so only payloads move (repro_torch.exchange; with optional delta
  iteration), or through the two-hop ``hierarchical_exchange`` of a
  (pod, *inner) axis.
- PMV_hybrid     (Alg. 4): the sparse region runs vertically with the compact
  or the packed exchange; the small dense sub-vector v_d is gathered
  (horizontal).

Backends (``StepConfig.backend``):
- 'torch': plain tensor ops (gather + segment combine) over the edge stripes.
- 'planned': the per-block ExecutionPlan (core/planner.py).  ELL-tactic
  blocks run the ELL GIM-V kernel per degree bucket, dense-tactic blocks and
  the hybrid dense region the dense GIM-V kernel; each destination row lives
  in exactly one bucket or dense block, so results are placed with a plain
  indexed copy.  :func:`flatten_planned` lays a stacked PlannedStripe out for
  this once, at prepare time: the worker axis is folded into the rows and the
  per-worker offsets are applied to rows and cols.

``scatter`` picks the receive side of the compact and packed exchanges in
both backends: 'segment' (segment combine) or 'kernel' (the scatter-combine
kernel; for the packed exchange its packed-id form, which decodes the
bit-packed ids in the kernel).

Multi-query: v_local may carry a trailing query axis ([b, n_local, Q], one
query per column, as PMVServer batches them).  Every step carries it through
gathers, segment combines, the exchange and assign; the planned executors
then take the Q-wide kernels (``ell_gimv_multi``, ``dense_gimv_multi``,
``scatter_combine_gimv_multi``), and the compact exchange keeps one index set
per partial row for all Q columns.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import collectives, sparse_exchange
from repro_torch.core.blocks import BlockEdges, DenseRegion, PlannedStripe
from repro_torch.core.gimv import (GimvSpec, combine2, combine_elementwise,
                                   segment_combine, tree_combine)
from repro_torch.exchange import runtime as packed_rt
from repro_torch.kernels.block_gimv import dense_gimv, dense_gimv_multi, semiring_of
from repro_torch.kernels.ell_spmv import check_left_packed, ell_gimv, ell_gimv_multi

__all__ = [
    "horizontal_step",
    "vertical_step",
    "hybrid_step",
    "block_gimv_partials",
    "gathered_gimv",
    "single_block_partial",
    "single_block_compact",
    "single_block_contrib",
    "ell_gimv_call",
    "FlatBucket",
    "FlatPlanned",
    "flatten_planned",
    "FlatStreamed",
    "flatten_streamed",
    "apply_assign",
    "hierarchical_exchange",
]


def _ident(spec: GimvSpec, device) -> torch.Tensor:
    return torch.full((), spec.identity, dtype=spec.torch_dtype, device=device)


def _num_queries(v_local: torch.Tensor) -> int | None:
    """Trailing query-axis size of the blocked vector ([b, n_local, Q]), or
    None for the single-vector path ([b, n_local])."""
    return v_local.shape[-1] if v_local.ndim == 3 else None


# --------------------------------------------------------------------------
# Plain tensor compute (backend='torch').
# --------------------------------------------------------------------------

def _edges_x(spec: GimvSpec, stripe: BlockEdges, v_flat: torch.Tensor,
             row_offset: torch.Tensor) -> torch.Tensor:
    """combine2 over all edges of stacked stripes [W, b, E_cap]: edge (w, k, e)
    reads v_flat[row_offset[w, k] + gat_local[w, k, e]].  Padding slots get
    the identity.  A trailing query axis on v_flat ([N, Q]) broadcasts the
    weights and the padding mask across queries: x [W, b, E_cap, Q]."""
    e_cap = stripe.seg_local.shape[-1]
    dev = v_flat.device
    mask = torch.arange(e_cap, device=dev)[None, None, :] < stripe.count[:, :, None]
    vj = v_flat[stripe.gat_local + row_offset[:, :, None]]
    w = stripe.w if spec.needs_weights else None
    if v_flat.ndim == 2:
        mask = mask[..., None]
        w = None if w is None else w[..., None]
    x = combine2(spec, w, vj)
    return torch.where(mask, x.to(vj.dtype), _ident(spec, dev))


def _segment_blocks(spec: GimvSpec, stripe: BlockEdges, x: torch.Tensor,
                    n_local: int) -> torch.Tensor:
    """Segment-combine [W, b, E_cap(, Q)] edge values into [W, b, n_local(, Q)]."""
    w_, b = x.shape[:2]
    tail = tuple(x.shape[3:])
    dev = x.device
    off = (torch.arange(w_ * b, device=dev).reshape(w_, b) * n_local)[:, :, None]
    flat = segment_combine(spec, x.reshape((-1,) + tail), (stripe.seg_local + off).reshape(-1),
                           w_ * b * n_local)
    return flat.reshape((w_, b, n_local) + tail)


def block_gimv_partials(spec: GimvSpec, stripe: BlockEdges, v_local: torch.Tensor,
                        n_local: int) -> torch.Tensor:
    """Vertical sub-multiplications v^(i,j) = M^(i,j) (x) v^(j) of every
    worker j: [b_w, b, n_local(, Q)] (identity where structurally empty)."""
    w_, b = stripe.count.shape
    row_off = (torch.arange(w_, device=v_local.device) * n_local)[:, None].expand(w_, b)
    x = _edges_x(spec, stripe, v_local.reshape((-1,) + tuple(v_local.shape[2:])), row_off)
    return _segment_blocks(spec, stripe, x, n_local)


def gathered_gimv(spec: GimvSpec, stripe: BlockEdges, v_blocks: torch.Tensor,
                  n_local: int) -> torch.Tensor:
    """Horizontal compute of every worker: r^(i) = combineAll_j M^(i,j) (x)
    v^(j), with v_blocks [b, m(, Q)] the gathered per-block source vectors
    (m = n_local, or d_cap for the hybrid dense region).  combineAll across
    source blocks is the pairwise tree fold (order set by b alone).
    Returns [b_w, n_local(, Q)]."""
    w_, b = stripe.count.shape
    m = v_blocks.shape[1]
    row_off = (torch.arange(b, device=v_blocks.device) * m)[None, :].expand(w_, b)
    x = _edges_x(spec, stripe, v_blocks.reshape((-1,) + tuple(v_blocks.shape[2:])), row_off)
    contribs = _segment_blocks(spec, stripe, x, n_local)
    return tree_combine(spec, [contribs[:, j] for j in range(b)])


def _single_block(spec: GimvSpec, seg, gat, w, cnt, v_flat: torch.Tensor,
                  row_offset: torch.Tensor, n_local: int) -> torch.Tensor:
    """One inner block of every worker's stripe (seg / gat / w [W, E_cap],
    cnt [W]) as a one-block slice of the stacked-stripe path: combine2 over
    its edges reading v_flat[row_offset[w] + gat], segment-combined into
    [W, n_local(, Q)].  Each output row folds the same edges in the same
    order as the whole-stripe call, so the result is that call's slice."""
    stripe = BlockEdges(seg_local=seg[:, None], gat_local=gat[:, None],
                        w=None if w is None else w[:, None], count=cnt[:, None])
    x = _edges_x(spec, stripe, v_flat, row_offset[:, None])
    return _segment_blocks(spec, stripe, x, n_local)[:, 0]


def single_block_partial(spec: GimvSpec, seg, gat, w, cnt, v_local: torch.Tensor,
                         n_local: int) -> torch.Tensor:
    """One destination block's vertical sub-multiplication on every worker:
    the block's edge arrays (seg / gat / w [W, E_cap], cnt [W]) against each
    worker's own vector v_local [W, n_local(, Q)] -> the dense partials
    [W, n_local(, Q)], bitwise block_gimv_partials(...)[:, i].  Shared by the
    compacting path (``single_block_compact``) and the packed exchange (which
    gathers the partial at its static row set instead)."""
    row_off = torch.arange(v_local.shape[0], device=v_local.device) * n_local
    v_flat = v_local.reshape((-1,) + tuple(v_local.shape[2:]))
    return _single_block(spec, seg, gat, w, cnt, v_flat, row_off, n_local)


def single_block_compact(spec: GimvSpec, seg, gat, w, cnt, v_local: torch.Tensor,
                         n_local: int, capacity: int):
    """``single_block_partial`` compacted at once: (idx [W, cap], val
    [W, cap(, Q)], overflow, logical), the per-block body of the out-of-core
    vertical executor (repro_torch.store), which must stay bitwise the
    resident step."""
    partial = single_block_partial(spec, seg, gat, w, cnt, v_local, n_local)
    return sparse_exchange.compact_partials(spec, partial, capacity,
                                            batched=v_local.ndim == 3)


def single_block_contrib(spec: GimvSpec, seg, gat, w, cnt, v_src: torch.Tensor,
                         n_local: int) -> torch.Tensor:
    """One source block's horizontal contribution to every worker: the
    block's edge arrays (seg / gat / w [W, E_cap], cnt [W]) against the
    SOURCE block's vector v_src [n_local(, Q)] -> [W, n_local(, Q)], the
    slice of ``gathered_gimv``'s per-block contributions that its tree fold
    combines.  The out-of-core horizontal executor streams these per source
    block."""
    row_off = torch.zeros(seg.shape[0], dtype=torch.int64, device=v_src.device)
    return _single_block(spec, seg, gat, w, cnt, v_src, row_off, n_local)


# --------------------------------------------------------------------------
# Kernel calls.
# --------------------------------------------------------------------------

def ell_gimv_call(spec: GimvSpec, cols, w, v):
    """One ELL table [R, D] through the ELL GIM-V kernel: v [N] -> r [R], or
    the multi-query kernel: v [N, Q] -> r [R, Q]."""
    fn = ell_gimv_multi if v.ndim == 2 else ell_gimv
    return fn(cols, w if spec.needs_weights else None, v,
              semiring=semiring_of(spec.combine2, spec.combine_all))


def _dense_call(spec: GimvSpec, matrix2d, operand):
    """One dense launch over a materialized matrix [M, K]: operand [K] ->
    r [M], or (multi-query kernel) operand [K, Q] -> r [M, Q]."""
    fn = dense_gimv_multi if operand.ndim == 2 else dense_gimv
    return fn(matrix2d, operand, semiring=semiring_of(spec.combine2, spec.combine_all))


def _dense_region_gimv(spec: GimvSpec, dense_matrix, v_d, n_local: int):
    """Hybrid dense region: the materialized [b_w * n_local, b * d_cap] matrix
    against the flat gathered dense sub-vector v_d [b, d_cap(, Q)], one dense
    kernel launch.  Returns r_dense [b_w, n_local(, Q)]."""
    tail = tuple(v_d.shape[2:])
    r = _dense_call(spec, dense_matrix, v_d.reshape((-1,) + tail).contiguous())
    return r.reshape((-1, n_local) + tail)


# --------------------------------------------------------------------------
# Planned executors (backend='planned').
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatBucket:
    """One ELL degree bucket with the worker axis folded into its rows."""

    rows: torch.Tensor          # [W*R] int64 flat output row; pads -> the drop slot
    cols: torch.Tensor          # [W*R, D] int32 index into the flat source vector; -1 pad
    w: torch.Tensor | None      # [W*R, D] float32, or None


@dataclasses.dataclass(frozen=True)
class FlatPlanned:
    """A stacked PlannedStripe laid out for emulation (see flatten_planned).

    Output space: [n_workers * rows_out + 1], the last slot the drop slot.
    layout='merged': dense_matrix [W, n_local, k*n_local] and dense_index
      [W, k] (source blocks whose v^(jj) feed the columns).
    layout='vertical': dense_matrix [W, k*n_local, n_local] and dense_rows
      [W, k*n_local] (flat output rows; stacking pads -> the drop slot).
    """

    buckets: tuple
    dense_matrix: torch.Tensor | None
    dense_index: torch.Tensor | None
    dense_rows: torch.Tensor | None
    rows_out: int
    n_workers: int
    layout: str

    @property
    def drop(self) -> int:
        return self.n_workers * self.rows_out


def flatten_planned(planned: PlannedStripe, n_local: int, n_workers: int,
                    device) -> FlatPlanned:
    """Stacked (numpy) PlannedStripe -> FlatPlanned tensors on ``device``.

    The offsets that put each worker's rows and sources into the flat
    emulation vectors are applied here once, not every iteration: a bucket
    row r of worker w writes output w * rows_out + r; a 'vertical' col c of
    worker w reads v_flat[w * n_local + c] ('merged' cols already index the
    flat gathered vector).  Refuses a bucket whose rows are not left-packed
    (``check_left_packed``), the layout the ELL kernels need."""
    assert planned.layout in ("vertical", "merged"), planned.layout
    rows_out = planned.rows_out
    n_w = n_workers
    drop = n_w * rows_out

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device, dtype=dtype or t.dtype)

    buckets = []
    for bk in planned.buckets:
        rows = np.asarray(bk.rows, dtype=np.int64)
        rows = np.where(rows >= 0, rows + np.arange(n_w)[:, None] * rows_out, drop)
        cols = np.asarray(bk.cols)
        if planned.layout == "vertical":
            cols = np.where(cols >= 0, cols + (np.arange(n_w, dtype=np.int32) * n_local)[:, None, None],
                            np.int32(-1)).astype(np.int32)
        d = cols.shape[-1]
        cols = put(cols.reshape(-1, d))
        check_left_packed(cols)
        buckets.append(FlatBucket(
            rows=put(rows.reshape(-1)), cols=cols,
            w=None if bk.w is None else put(np.asarray(bk.w).reshape(-1, d))))

    dense_matrix = dense_index = dense_rows = None
    if planned.dense is not None:
        mat = np.asarray(planned.dense.matrix)
        index = np.asarray(planned.dense.index, dtype=np.int64)
        if planned.layout == "vertical":
            k = index.shape[1]
            dense_matrix = put(mat.reshape(n_w, k * n_local, n_local))
            ar = np.arange(n_local)[None, None, :]
            rows = np.where(index[:, :, None] >= 0,
                            np.arange(n_w)[:, None, None] * rows_out + index[:, :, None] * n_local + ar,
                            drop)
            dense_rows = put(rows.reshape(n_w, k * n_local))
        else:
            dense_matrix = put(mat)
            dense_index = put(index)
    return FlatPlanned(buckets=tuple(buckets), dense_matrix=dense_matrix,
                       dense_index=dense_index, dense_rows=dense_rows,
                       rows_out=rows_out, n_workers=n_w, layout=planned.layout)


@dataclasses.dataclass(frozen=True)
class FlatStreamed:
    """A stacked streamed PlannedStripe laid out for emulation (see
    flatten_streamed).  Each bucket is a FlatBucket with a leading
    destination-block axis: rows [b, W*R] into the flat partial chunk
    [W * n_local + 1] (the last slot the drop slot), cols [b, W*R, D] into
    v_flat [W * n_local].  ``active[k]`` lists the buckets that hold a row
    of destination block k on some worker: step k launches only those.
    Dense-tactic blocks: dense_matrix [W, k_max, n_local, n_local] with
    ``dense_blocks[w]`` the destination block of each real matrix (the
    stacking pads are left out), one dense launch per (worker, block)."""

    buckets: tuple
    active: tuple               # tuple[tuple[int, ...], ...], one entry per block
    dense_matrix: torch.Tensor | None
    dense_blocks: tuple         # tuple[tuple[int, ...], ...], one entry per worker
    n_local: int
    n_workers: int

    @property
    def n_blocks(self) -> int:
        return len(self.active)

    @property
    def drop(self) -> int:
        return self.n_workers * self.n_local

    def launches_per_step(self) -> int:
        """ELL launches one streamed step makes: the active buckets summed
        over the destination blocks."""
        return sum(len(a) for a in self.active)


def flatten_streamed(streamed: PlannedStripe, n_local: int, n_workers: int,
                     device) -> FlatStreamed:
    """Stacked block-major streamed PlannedStripe (``blocks.stack_streamed``
    with worker_axis=1: bucket rows [b, W, R], cols [b, W, R, D]) ->
    FlatStreamed tensors on ``device``, put there once at prepare.  The
    worker offsets are applied here: a bucket row r of worker w writes chunk
    slot w * n_local + r (pads -> the drop slot), a col c of worker w reads
    v_flat[w * n_local + c], so that step k takes views ``[k]`` and copies
    nothing.  Refuses a bucket whose rows are not left-packed
    (``check_left_packed``), the layout the ELL kernels need."""
    assert streamed.layout == "streamed", streamed.layout
    n_w = n_workers
    drop = n_w * n_local
    b = streamed.rows_out // n_local

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    buckets, valid = [], []
    for bk in streamed.buckets:
        rows = np.asarray(bk.rows, dtype=np.int64)              # [b, W, R]
        rows = np.where(rows >= 0, rows + (np.arange(n_w) * n_local)[None, :, None], drop)
        cols = np.asarray(bk.cols)
        col_off = (np.arange(n_w, dtype=np.int32) * n_local)[None, :, None, None]
        cols = np.where(cols >= 0, cols + col_off, np.int32(-1)).astype(np.int32)
        d = cols.shape[-1]
        cols_t = put(cols.reshape(b, -1, d))
        check_left_packed(cols_t.reshape(-1, d))
        buckets.append(FlatBucket(
            rows=put(rows.reshape(b, -1)), cols=cols_t,
            w=None if bk.w is None else put(np.asarray(bk.w).reshape(b, -1, d))))
        valid.append((rows < drop).reshape(b, -1).any(axis=1))
    active = tuple(tuple(i for i in range(len(buckets)) if valid[i][k]) for k in range(b))
    dense_matrix, dense_blocks = None, ((),) * n_w
    if streamed.dense is not None:
        dense_matrix = put(np.asarray(streamed.dense.matrix))
        dense_blocks = tuple(tuple(int(i) for i in row if i >= 0)
                             for row in np.asarray(streamed.dense.index))
    return FlatStreamed(buckets=tuple(buckets), active=active, dense_matrix=dense_matrix,
                        dense_blocks=dense_blocks, n_local=n_local, n_workers=n_w)


def _planned_out(spec: GimvSpec, fp: FlatPlanned, v_flat: torch.Tensor) -> torch.Tensor:
    """Run every ELL bucket against v_flat [N(, Q)] and place its rows in the
    flat output [drop + 1(, Q)] (identity where no bucket has the row)."""
    out = torch.full((fp.drop + 1,) + tuple(v_flat.shape[1:]), spec.identity,
                     dtype=spec.torch_dtype, device=v_flat.device)
    for bk in fp.buckets:
        out.index_copy_(0, bk.rows, ell_gimv_call(spec, bk.cols, bk.w, v_flat))
    return out


def _planned_merged_gimv(spec: GimvSpec, fp: FlatPlanned, v_all: torch.Tensor,
                         n_local: int) -> torch.Tensor:
    """Planned horizontal compute: per-bucket ELL launches against the flat
    gathered vector v_all [b, n_local(, Q)] plus one dense launch per
    worker.  Returns r [b_w, n_local(, Q)] for the fp.n_workers workers."""
    b_w = fp.n_workers
    tail = tuple(v_all.shape[2:])
    out = _planned_out(spec, fp, v_all.reshape((-1,) + tail))
    r_all = out[:fp.drop].reshape((b_w, n_local) + tail)
    if fp.dense_matrix is not None:
        r_ds = [_dense_call(spec, fp.dense_matrix[wk],
                            v_all[fp.dense_index[wk]].reshape((-1,) + tail))
                for wk in range(b_w)]
        r_all = combine_elementwise(spec, r_all, torch.stack(r_ds))
    return r_all


def _planned_vertical_partials(spec: GimvSpec, fp: FlatPlanned, v_local: torch.Tensor,
                               n_local: int) -> torch.Tensor:
    """Planned vertical compute: all destination-block partials through the
    per-bucket ELL launches plus one dense launch per worker, placed into the
    flat partial space.  Returns partials [b_w, b, n_local(, Q)]."""
    b_w = v_local.shape[0]
    tail = tuple(v_local.shape[2:])
    out = _planned_out(spec, fp, v_local.reshape((-1,) + tail))
    if fp.dense_matrix is not None:
        for wk in range(b_w):
            out.index_copy_(0, fp.dense_rows[wk],
                            _dense_call(spec, fp.dense_matrix[wk], v_local[wk]))
    return out[:fp.drop].reshape((b_w, fp.rows_out // n_local, n_local) + tail)


def _streamed_blocks(spec: GimvSpec, fs: FlatStreamed, v_local: torch.Tensor):
    """The bucket-streamed schedule (plan.stream='on'): yields (k, chunk)
    for each destination block k, chunk [b_w, n_local(, Q)] its partial on
    every worker, or None where no ELL row feeds the block (the identity).
    Block k runs its active buckets' ELL launches into one identity-filled
    chunk buffer, allocated once and refilled each step, so a single
    partial is live at a time; each chunk must be consumed before the next
    step overwrites it.  Dense-tactic blocks are not in it (see
    :func:`_streamed_dense`)."""
    tail = tuple(v_local.shape[2:])
    v_flat = v_local.reshape((-1,) + tail)
    out = torch.empty((fs.drop + 1,) + tail, dtype=spec.torch_dtype, device=v_local.device)
    for k, act in enumerate(fs.active):
        if not act:
            yield k, None
            continue
        out.fill_(spec.identity)
        for i in act:
            bk = fs.buckets[i]
            out.index_copy_(0, bk.rows[k], ell_gimv_call(
                spec, bk.cols[k], None if bk.w is None else bk.w[k], v_flat))
        yield k, out[:fs.drop].reshape((fs.n_workers, fs.n_local) + tail)


def _streamed_dense(spec: GimvSpec, fs: FlatStreamed, v_local: torch.Tensor):
    """Dense-tactic blocks of the streamed layout: yields (worker, block,
    r [n_local(, Q)]), one dense launch per (worker, block).  The tactics
    are exclusive, so each overwrites rows the ELL steps left at the
    identity."""
    for wk, blocks in enumerate(fs.dense_blocks):
        for t, i in enumerate(blocks):
            yield wk, i, _dense_call(spec, fs.dense_matrix[wk, t], v_local[wk])


def _streamed_planned_compact(spec: GimvSpec, fs: FlatStreamed, v_local: torch.Tensor,
                              capacity: int, axis=None):
    """Streamed planned vertical compute + compaction: each destination
    block's partial is compacted into its slot [:, k] of the [b_w, b, cap]
    exchange buffers as soon as it is produced (the paper Alg. 2's
    store-as-produced schedule), so live memory is O(b_w * n_local +
    b_w * b * cap) where the fused executor holds [b_w, b, n_local].
    Per-row compaction is independent, so the buffers equal
    ``compact_partials`` over the fused partials.  Returns (idx, val,
    overflow, logical) as that function does, the counters summed over the
    worker ``axis``."""
    b_w = v_local.shape[0]
    tail = tuple(v_local.shape[2:])
    batched = bool(tail)
    cap = min(capacity, fs.n_local)
    dev = v_local.device
    idx = torch.empty((b_w, fs.n_blocks, cap), dtype=torch.int32, device=dev)
    val = torch.empty((b_w, fs.n_blocks, cap) + tail, dtype=spec.torch_dtype, device=dev)
    overflow = torch.zeros((), dtype=torch.float32, device=dev)
    logical = torch.zeros((), dtype=torch.float32, device=dev)

    def put(sl, chunk):
        nonlocal overflow, logical
        i, v, ov, lg = sparse_exchange.compact_chunk(spec, chunk, capacity, batched=batched)
        idx[sl], val[sl] = i, v
        overflow, logical = overflow + ov, logical + lg

    for k, chunk in _streamed_blocks(spec, fs, v_local):
        if chunk is None:
            idx[:, k] = fs.n_local
            val[:, k] = spec.identity
        else:
            put((slice(None), k), chunk)
    for wk, i, r_d in _streamed_dense(spec, fs, v_local):
        put((wk, i), r_d)
    return idx, val, collectives.psum(overflow, axis), collectives.psum(logical, axis)


def _streamed_planned_payload(spec: GimvSpec, fs: FlatStreamed, v_local: torch.Tensor,
                              send_rows: torch.Tensor) -> torch.Tensor:
    """Streamed planned vertical compute feeding the packed exchange: the
    schedule of ``_streamed_planned_compact`` with each block's partial
    gathered at its static send rows ``send_rows[:, k]`` into slot [:, k]
    of the [b_w, b, p(, Q)] payload, in place of compaction.  Equals
    ``gather_payload`` over the fused partials."""
    b_w, b, p = send_rows.shape
    tail = tuple(v_local.shape[2:])
    payload = torch.empty((b_w, b, p) + tail, dtype=spec.torch_dtype, device=v_local.device)
    for k, chunk in _streamed_blocks(spec, fs, v_local):
        if chunk is None:
            payload[:, k] = spec.identity
        else:
            payload[:, k] = packed_rt.gather_payload(spec, chunk, send_rows[:, k])
    for wk, i, r_d in _streamed_dense(spec, fs, v_local):
        payload[wk, i] = packed_rt.gather_payload(spec, r_d, send_rows[wk, i])
    return payload


# --------------------------------------------------------------------------
# Placement steps: take/return the blocked vector v_local [b, n_local(, Q)]
# and return (v_new, r, stats).  stats counts GLOBAL elements / bytes per
# iteration (a Q-wide batch moves Q values per element); values are Python
# floats or float32 scalar tensors.
# --------------------------------------------------------------------------

def apply_assign(spec: GimvSpec, v_local, r_local, ctx_local, real_mask):
    """assign, with padding ids (real_mask False) frozen; the mask broadcasts
    over a trailing query axis."""
    v_new = spec.assign(v_local, r_local, ctx_local)
    if v_new.ndim > real_mask.ndim:
        real_mask = real_mask[..., None]
    return torch.where(real_mask, v_new.to(v_local.dtype), v_local)


def horizontal_step(spec: GimvSpec, stripe: BlockEdges | None, v_local, ctx_local,
                    real_mask, *, n_local: int, planned: FlatPlanned | None = None,
                    backend: str = "torch", axis=None):
    """Alg. 1: gather the whole vector, compute the row stripe locally."""
    nq = _num_queries(v_local)
    v_all = collectives.all_gather(v_local, axis)              # [b, n_local(, Q)]
    if backend == "planned":
        r = _planned_merged_gimv(spec, planned, v_all, n_local)
    else:
        r = gathered_gimv(spec, stripe, v_all, n_local)
    v_new = apply_assign(spec, v_local, r, ctx_local, real_mask)
    b = v_all.shape[0]
    vb = np.dtype(spec.dtype).itemsize
    stats = {
        "gathered_elems": float(b * (b - 1) * n_local * (nq or 1)),
        "exchanged_elems": 0.0,
        "gathered_bytes": float(b * (b - 1) * n_local * (nq or 1) * vb),
        "exchanged_bytes": 0.0,
    }
    return v_new, r, stats


def _to_wire(val: torch.Tensor, payload_dtype):
    """(values as they cross the wire, their itemsize): cast to
    ``payload_dtype`` when one is set (torch rounds to nearest even, as
    JAX's cast does)."""
    if payload_dtype is not None:
        val = val.to(payload_dtype)
    return val, val.element_size()


def _compact_exchange(spec: GimvSpec, compacted, capacity: int, n_local: int, scatter: str,
                      nq: int | None, payload_dtype=None, axis=None):
    """Exchange compacted partials (idx [b_w, b, cap], val [b_w, b, cap(, Q)],
    overflow, logical) all-to-all and fold them at their owners, the values
    on the wire in ``payload_dtype`` (None: the spec dtype).  Returns
    (r [b_w, n_local(, Q)], stats)."""
    idx, val, overflow, logical = compacted
    val, itemsize = _to_wire(val, payload_dtype)
    # the fold runs in the spec dtype (.to is the identity without a wire cast)
    r = sparse_exchange.scatter_partials(spec, collectives.all_to_all(idx, axis),
                                         collectives.all_to_all(val, axis).to(spec.torch_dtype),
                                         n_local, method=scatter)
    b = idx.shape[-2]
    id_b, pay_b = sparse_exchange.exchange_wire_split(b, capacity, nq, itemsize)
    stats = {
        "gathered_elems": 0.0,
        "exchanged_elems": float(b * (b - 1) * capacity * (1 + (nq or 1))),
        "gathered_bytes": 0.0,
        "exchanged_bytes": sparse_exchange.exchange_wire_bytes(b, capacity, nq, itemsize),
        "exchange_id_bytes": id_b,
        "exchange_payload_bytes": pay_b,
        "logical_elems": logical,
        "overflow": overflow,
    }
    return r, stats


def _compact_partials(spec: GimvSpec, v_local, n_local: int, capacity: int, *, stripe=None,
                      planned: FlatPlanned | None = None,
                      streamed: FlatStreamed | None = None, backend: str = "torch", axis=None):
    """The vertical partials, through whichever executor, compacted to
    (idx, val, overflow, logical) of static ``capacity``, the counters
    summed over the worker ``axis``: the streamed executor compacts block by
    block, the others compact all b at once."""
    if backend == "planned" and streamed is not None:
        return _streamed_planned_compact(spec, streamed, v_local, capacity, axis)
    if backend == "planned":
        partials = _planned_vertical_partials(spec, planned, v_local, n_local)
    else:
        partials = block_gimv_partials(spec, stripe, v_local, n_local)
    return sparse_exchange.compact_partials(spec, partials, capacity, axis,
                                            batched=v_local.ndim == 3)


def _packed_payload(spec: GimvSpec, v_local, n_local: int, send_rows, *, stripe=None,
                    planned: FlatPlanned | None = None, streamed: FlatStreamed | None = None,
                    backend: str = "torch") -> torch.Tensor:
    """The vertical partials, through whichever executor, gathered at the
    packed send order ``send_rows`` [b_w, b, p] -> payload [b_w, b, p(, Q)]."""
    if backend == "planned" and streamed is not None:
        return _streamed_planned_payload(spec, streamed, v_local, send_rows)
    if backend == "planned":
        partials = _planned_vertical_partials(spec, planned, v_local, n_local)
    else:
        partials = block_gimv_partials(spec, stripe, v_local, n_local)
    return packed_rt.gather_payload(spec, partials, send_rows)


def _ship_packed(spec: GimvSpec, payload, xchg: dict, xplan, n_local: int, scatter: str,
                 nq: int | None, *, delta_eps: float | None = None, delta_state=None,
                 payload_dtype=None, axis=None):
    """Ship a packed payload [b_w, b, p(, Q)]: cast it to the wire dtype
    ``payload_dtype`` (None: the spec dtype) BEFORE the delta test, suppress
    unmoved rows when ``delta_state`` (the previously shipped payload, in
    the wire dtype) is given, exchange all-to-all and fold at the owners in
    the spec dtype.  Returns (r [b_w, n_local(, Q)], stats, shipped payload
    or None).  The ids crossed the wire once, at prepare: the per-iteration
    stats charge payloads, plus the send bitmap under delta iteration."""
    send_rows = xchg["send_rows"]
    logical = packed_rt.payload_logical(spec, payload, axis)
    payload, itemsize = _to_wire(payload, payload_dtype)
    shipped = None
    if delta_state is not None:
        pair_mask = packed_rt.pair_slot_mask(send_rows, n_local, axis)
        payload, sent, suppressed = packed_rt.delta_update(
            spec, payload, delta_state, delta_eps or 0.0, pair_mask, axis)
        shipped = payload
        payload_bytes = sent * float((nq or 1) * itemsize) + float(xplan.bitmap_bytes)
    else:
        payload_bytes = xplan.payload_bytes_per_iter(nq, itemsize)
    r = packed_rt.scatter_payload(
        spec, collectives.all_to_all(payload, axis).to(spec.torch_dtype), n_local,
        recv_rows=xchg.get("recv_rows"),
        recv_words=xchg.get("recv_words"), p_dev=xplan.p_dev, width=xplan.width_dev,
        method=scatter)
    b = send_rows.shape[-2]
    stats = {
        "gathered_elems": 0.0,
        "exchanged_elems": float(b * (b - 1) * xplan.p_dev * (nq or 1)),
        "gathered_bytes": 0.0,
        "exchanged_bytes": payload_bytes,
        "exchange_payload_bytes": payload_bytes,
        "exchange_id_bytes": float(xplan.id_bytes),
        "logical_elems": logical,
        "overflow": 0.0,
    }
    if delta_state is not None:
        stats["delta_sent_rows"] = sent
        stats["delta_suppressed_rows"] = suppressed
    return r, stats, shipped


def hierarchical_exchange(spec: GimvSpec, idx, val, n_local: int, axis, *,
                          scatter: str = "segment"):
    """Two-hop exchange of compacted partials on a (pod, *inner) worker axis.

    Partial rows are ordered by global destination worker g = p * W + w.
    Hop 1, over the inner dims: worker w collects its pod's W partials for
    every destination pod and folds them (the receive-side ``scatter``
    tactic) into one [P, n_local] tensor, so overlapping destinations are
    combined before the slow hop.  Hop 2, over the pod dim: the combined
    rows go all-to-all across the pods, then the final combine.  A trailing
    query axis on ``val`` ([1, b, cap, Q], one index set per row) rides
    through both hops.  idx / val are this rank's [1, b, cap(, Q)] (values in
    their wire dtype); returns (r [1, n_local(, Q)], stats), the stats the
    closed forms of the GLOBAL elements per iteration."""
    groups = collectives.hier_groups(axis)
    n_pods, w_size = groups.n_pods, groups.w_size
    cap = idx.shape[-1]
    tail = tuple(val.shape[3:])
    nq = tail[0] if tail else None
    # hop 1: row w' of each pod's [W, cap] goes to inner worker w', which
    # receives [W_src, P, cap] and folds the W senders of each pod set
    def hop1(x):                                   # [P, W_dest, cap(, Q)] -> [P, W_src, ...]
        x = x[0].reshape((n_pods, w_size, cap) + tuple(x.shape[3:])).transpose(0, 1)
        return collectives.all_to_all_rows(x, groups.inner).transpose(0, 1)

    idx_r, val_r = hop1(idx), hop1(val)
    per_pod = sparse_exchange.scatter_partials(
        spec, idx_r.contiguous(), val_r.to(spec.torch_dtype).contiguous(), n_local,
        method=scatter)                                               # [P, n_local(, Q)]
    # hop 2: the combined rows across the pods, then the final combine
    received = collectives.all_to_all_rows(per_pod, groups.pod)
    r = _combine_received(spec, received, 0)
    stats = {
        "intra_pod_elems": float(n_pods) ** 2 * w_size * (w_size - 1) * cap * (1 + (nq or 1)),
        "inter_pod_elems": float(n_pods) * (n_pods - 1) * w_size * n_local * (nq or 1),
    }
    return r[None], stats


def _combine_received(spec: GimvSpec, received: torch.Tensor, dim: int) -> torch.Tensor:
    """combineAll of received dense partials along ``dim``."""
    if spec.combine_all == "sum":
        return received.sum(dim=dim, dtype=received.dtype)
    if spec.combine_all == "min":
        return received.amin(dim=dim)
    return received.amax(dim=dim)


def vertical_step(spec: GimvSpec, stripe: BlockEdges | None, v_local, ctx_local, real_mask,
                  *, n_local: int, exchange: str = "sparse", capacity: int | None = None,
                  planned: FlatPlanned | None = None, streamed: FlatStreamed | None = None,
                  backend: str = "torch", scatter: str = "segment", xchg: dict | None = None,
                  xplan=None, delta_eps: float | None = None, delta_state=None,
                  payload_dtype=None, axis=None):
    """Alg. 2: local column-stripe partials, exchange, combine at the owner.

    exchange='dense' ships the full [b, n_local] partials; 'sparse' compacts
    them to (idx, val) pairs of static ``capacity`` first -- the paper's
    "only non-empty v^(i,j) entries" transport; 'packed' gathers them at the
    static row sets of ``xchg`` / ``xplan`` (repro_torch.exchange); 'hier'
    compacts as 'sparse' does, then takes the two-hop
    :func:`hierarchical_exchange` of a (pod, *inner) worker ``axis``.  With
    ``delta_state`` (packed only) the step also returns the new state as a
    fourth element.  backend='planned' runs the plan's tactics either fused
    (``planned``: all partials at once) or bucket-streamed one destination
    block at a time (``streamed``, plan.stream='on'; the sparse, packed and
    hier exchanges only -- the dense exchange ships the full partials).
    ``payload_dtype`` (a torch dtype) is the wire dtype of the sparse,
    packed and hier exchanges' values; the dense exchange ships the spec
    dtype, as in the JAX package."""
    nq = _num_queries(v_local)
    kw = dict(stripe=stripe, planned=planned, streamed=streamed, backend=backend)
    shipped = None
    if exchange == "dense":
        assert streamed is None, "the dense exchange takes the fused layout"
        if backend == "planned":
            partials = _planned_vertical_partials(spec, planned, v_local, n_local)
        else:
            partials = block_gimv_partials(spec, stripe, v_local, n_local)
        b = partials.shape[1]
        # [b_dest, b_sender, n_local(, Q)]
        r = _combine_received(spec, collectives.all_to_all(partials, axis), 1)
        stats = {
            "gathered_elems": 0.0,
            "exchanged_elems": float(b * (b - 1) * n_local * (nq or 1)),
            "gathered_bytes": 0.0,
            "exchanged_bytes": float(b * (b - 1) * n_local * (nq or 1)
                                     * partials.element_size()),
            "logical_elems": collectives.psum(
                (partials != spec.identity).sum(), axis).to(torch.float32),
        }
    elif exchange == "sparse":
        assert capacity is not None, "sparse exchange needs a static capacity"
        r, stats = _compact_exchange(
            spec, _compact_partials(spec, v_local, n_local, capacity, axis=axis, **kw),
            capacity, n_local, scatter, nq, payload_dtype, axis)
    elif exchange == "hier":
        assert capacity is not None, "the hier exchange needs a static capacity"
        idx, val, overflow, logical = _compact_partials(spec, v_local, n_local, capacity,
                                                        axis=axis, **kw)
        val, itemsize = _to_wire(val, payload_dtype)
        r, hstats = hierarchical_exchange(spec, idx, val, n_local, axis, scatter=scatter)
        # wire bytes: the intra slots ship an int32 index plus the payload
        # values, the inter hop the combined partials in the spec dtype
        intra_slots = hstats["intra_pod_elems"] / (1.0 + (nq or 1))
        stats = {
            "gathered_elems": 0.0,
            "exchanged_elems": hstats["intra_pod_elems"] + hstats["inter_pod_elems"],
            **hstats,
            "gathered_bytes": 0.0,
            "exchanged_bytes": (intra_slots * (4.0 + (nq or 1) * itemsize)
                                + hstats["inter_pod_elems"] * np.dtype(spec.dtype).itemsize),
            "logical_elems": logical,
            "overflow": overflow,
        }
    elif exchange == "packed":
        assert xchg is not None and xplan is not None, \
            "packed exchange needs the prepare-built index arrays and plan"
        payload = _packed_payload(spec, v_local, n_local, xchg["send_rows"], **kw)
        r, stats, shipped = _ship_packed(spec, payload, xchg, xplan, n_local, scatter, nq,
                                         delta_eps=delta_eps, delta_state=delta_state,
                                         payload_dtype=payload_dtype, axis=axis)
    else:
        raise ValueError(f"unknown exchange {exchange!r}")
    v_new = apply_assign(spec, v_local, r, ctx_local, real_mask)
    if delta_state is not None:
        return v_new, r, stats, shipped
    return v_new, r, stats


def hybrid_step(spec: GimvSpec, sparse_stripe: BlockEdges | None,
                dense_stripe: BlockEdges | None, dense_region: DenseRegion, v_local,
                ctx_local, real_mask, *, n_local: int, capacity: int,
                planned_sparse: FlatPlanned | None = None,
                streamed_sparse: FlatStreamed | None = None, dense_matrix=None,
                backend: str = "torch", scatter: str = "segment", exchange: str = "sparse",
                xchg: dict | None = None, xplan=None, payload_dtype=None, axis=None):
    """Alg. 4: vertical over the sparse region + horizontal over the dense
    region, combined at the owner, then assign.  The dense sub-vector v_d
    is the compacted gather of high-out-degree entries [b_w, d_cap],
    all-gathered to [b, d_cap]; backend 'planned' runs the dense region
    through the dense GIM-V kernel on the materialized ``dense_matrix`` and
    the sparse region through the plan, fused (``planned_sparse``) or
    bucket-streamed per destination block (``streamed_sparse``,
    plan.stream='on').  The sparse region's partials take the packed
    exchange when ``exchange`` is 'packed', else the compact one (hybrid has
    no dense or two-hop exchange), their values on the wire in
    ``payload_dtype`` (None: the spec dtype)."""
    nq = _num_queries(v_local)
    gather_idx = dense_region.gather_idx                           # [b_w, d_cap]
    if nq is not None:
        gather_idx = gather_idx[:, :, None].expand(-1, -1, nq)
    v_d = collectives.all_gather(torch.gather(v_local, 1, gather_idx), axis)  # [b, d_cap(, Q)]
    if backend == "planned":
        r_dense = _dense_region_gimv(spec, dense_matrix, v_d, n_local)
    else:
        r_dense = gathered_gimv(spec, dense_stripe, v_d, n_local)
    kw = dict(stripe=sparse_stripe, planned=planned_sparse, streamed=streamed_sparse,
              backend=backend)
    if exchange == "packed":
        assert xchg is not None and xplan is not None, \
            "packed exchange needs the prepare-built index arrays and plan"
        payload = _packed_payload(spec, v_local, n_local, xchg["send_rows"], **kw)
        r_sparse, stats, _ = _ship_packed(spec, payload, xchg, xplan, n_local, scatter, nq,
                                          payload_dtype=payload_dtype, axis=axis)
    else:
        r_sparse, stats = _compact_exchange(
            spec, _compact_partials(spec, v_local, n_local, capacity, axis=axis, **kw),
            capacity, n_local, scatter, nq, payload_dtype, axis)
    r = combine_elementwise(spec, r_sparse, r_dense)
    v_new = apply_assign(spec, v_local, r, ctx_local, real_mask)
    b = v_d.shape[0]
    d_cap = dense_region.d_cap
    stats["gathered_elems"] = float(b * (b - 1) * d_cap * (nq or 1))
    stats["gathered_bytes"] = float(b * (b - 1) * d_cap * (nq or 1)
                                    * np.dtype(spec.dtype).itemsize)
    return v_new, r, stats
