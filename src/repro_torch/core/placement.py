"""PMV placement strategies (paper §3.2-3.5) in emulation mode.

All b workers run on one device: every per-worker array carries an explicit
leading worker axis.  The all-gather of the horizontal placement is a
broadcast (every worker reads the one blocked vector [b, n_local]) and the
all-to-all of the vertical placement a transpose of the first two axes.

- PMV_horizontal (Alg. 1): gather the whole vector, compute the local stripe.
- PMV_vertical   (Alg. 2): local column-stripe partials v^(i,j), exchanged
  dense ([b, n_local]), compacted to (idx, val) pairs (sparse_exchange.py),
  or packed: gathered at the static per-pair row sets that prepare derived
  once, so only payloads move (repro_torch.exchange; with optional delta
  iteration).
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

from repro_torch.core import sparse_exchange
from repro_torch.core.blocks import BlockEdges, DenseRegion, PlannedStripe
from repro_torch.core.gimv import (GimvSpec, combine2, combine_elementwise,
                                   segment_combine, tree_combine)
from repro_torch.exchange import runtime as packed_rt
from repro_torch.kernels.block_gimv import dense_gimv, dense_gimv_multi, semiring_of
from repro_torch.kernels.ell_spmv import ell_gimv, ell_gimv_multi

__all__ = [
    "horizontal_step",
    "vertical_step",
    "hybrid_step",
    "block_gimv_partials",
    "gathered_gimv",
    "ell_gimv_call",
    "FlatBucket",
    "FlatPlanned",
    "flatten_planned",
    "apply_assign",
]


def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    """[b_sender, b_dest, .] -> [b_dest, b_sender, .]."""
    return x.transpose(0, 1).contiguous()


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
    flat gathered vector)."""
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
        buckets.append(FlatBucket(
            rows=put(rows.reshape(-1)), cols=put(cols.reshape(-1, d)),
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


def _planned_out(spec: GimvSpec, fp: FlatPlanned, v_flat: torch.Tensor) -> torch.Tensor:
    """Run every ELL bucket against v_flat [N(, Q)] and place its rows in the
    flat output [drop + 1(, Q)] (identity where no bucket has the row)."""
    out = torch.full((fp.drop + 1,) + tuple(v_flat.shape[1:]), spec.identity,
                     dtype=spec.torch_dtype, device=v_flat.device)
    for bk in fp.buckets:
        out.index_copy_(0, bk.rows, ell_gimv_call(spec, bk.cols, bk.w, v_flat))
    return out


def _planned_merged_gimv(spec: GimvSpec, fp: FlatPlanned, v_local: torch.Tensor,
                         n_local: int) -> torch.Tensor:
    """Planned horizontal compute: per-bucket ELL launches against the flat
    gathered vector (which in emulation is v_local itself) plus one dense
    launch per worker.  Returns r [b_w, n_local(, Q)]."""
    b_w = v_local.shape[0]
    tail = tuple(v_local.shape[2:])
    out = _planned_out(spec, fp, v_local.reshape((-1,) + tail))
    r_all = out[:fp.drop].reshape((b_w, n_local) + tail)
    if fp.dense_matrix is not None:
        r_ds = [_dense_call(spec, fp.dense_matrix[wk],
                            v_local[fp.dense_index[wk]].reshape((-1,) + tail))
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
                    backend: str = "torch"):
    """Alg. 1: gather the whole vector, compute the row stripe locally."""
    nq = _num_queries(v_local)
    if backend == "planned":
        r = _planned_merged_gimv(spec, planned, v_local, n_local)
    else:
        r = gathered_gimv(spec, stripe, v_local, n_local)
    v_new = apply_assign(spec, v_local, r, ctx_local, real_mask)
    b = v_local.shape[0]
    vb = np.dtype(spec.dtype).itemsize
    stats = {
        "gathered_elems": float(b * (b - 1) * n_local * (nq or 1)),
        "exchanged_elems": 0.0,
        "gathered_bytes": float(b * (b - 1) * n_local * (nq or 1) * vb),
        "exchanged_bytes": 0.0,
    }
    return v_new, r, stats


def _compact_exchange(spec: GimvSpec, partials, capacity: int, n_local: int, scatter: str,
                      nq: int | None):
    """Compact the [b_w, b, n_local(, Q)] partials, exchange them (transpose)
    and fold them at their owners.  Returns (r [b, n_local(, Q)], stats)."""
    idx, val, overflow, logical = sparse_exchange.compact_partials(
        spec, partials, capacity, batched=nq is not None)
    r = sparse_exchange.scatter_partials(spec, _all_to_all(idx), _all_to_all(val), n_local,
                                         method=scatter)
    b = idx.shape[-2]
    itemsize = np.dtype(spec.dtype).itemsize
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


def _packed_exchange(spec: GimvSpec, partials, xchg: dict, xplan, n_local: int, scatter: str,
                     nq: int | None, *, delta_eps: float | None = None, delta_state=None):
    """The packed exchange of the [b_w, b, n_local(, Q)] partials: gather
    each pair's payload at its static send order, suppress unmoved rows when
    ``delta_state`` (the previously shipped payload [b_w, b, p_dev]) is given,
    exchange (transpose) and fold at the owners.  Returns (r [b, n_local(, Q)],
    stats, shipped payload or None).  The ids crossed the wire once, at
    prepare: the per-iteration stats charge payloads, plus the send bitmap
    under delta iteration."""
    send_rows = xchg["send_rows"]
    payload = packed_rt.gather_payload(spec, partials, send_rows)
    logical = packed_rt.payload_logical(spec, payload)
    itemsize = payload.element_size()
    shipped = None
    if delta_state is not None:
        pair_mask = packed_rt.pair_slot_mask(send_rows, n_local)
        payload, sent, suppressed = packed_rt.delta_update(
            spec, payload, delta_state, delta_eps or 0.0, pair_mask)
        shipped = payload
        payload_bytes = sent * float((nq or 1) * itemsize) + float(xplan.bitmap_bytes)
    else:
        payload_bytes = xplan.payload_bytes_per_iter(nq, itemsize)
    r = packed_rt.scatter_payload(
        spec, _all_to_all(payload), n_local, recv_rows=xchg.get("recv_rows"),
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


def vertical_step(spec: GimvSpec, stripe: BlockEdges | None, v_local, ctx_local, real_mask,
                  *, n_local: int, exchange: str = "sparse", capacity: int | None = None,
                  planned: FlatPlanned | None = None, backend: str = "torch",
                  scatter: str = "segment", xchg: dict | None = None, xplan=None,
                  delta_eps: float | None = None, delta_state=None):
    """Alg. 2: local column-stripe partials, exchange, combine at the owner.

    exchange='dense' ships the full [b, n_local] partials; 'sparse' compacts
    them to (idx, val) pairs of static ``capacity`` first -- the paper's
    "only non-empty v^(i,j) entries" transport; 'packed' gathers them at the
    static row sets of ``xchg`` / ``xplan`` (repro_torch.exchange).  With
    ``delta_state`` (packed only) the step also returns the new state as a
    fourth element."""
    nq = _num_queries(v_local)
    if backend == "planned":
        partials = _planned_vertical_partials(spec, planned, v_local, n_local)
    else:
        partials = block_gimv_partials(spec, stripe, v_local, n_local)
    b = partials.shape[1]
    shipped = None
    if exchange == "dense":
        received = _all_to_all(partials)            # [b_dest, b_sender, n_local]
        if spec.combine_all == "sum":
            r = received.sum(dim=1, dtype=partials.dtype)
        elif spec.combine_all == "min":
            r = received.amin(dim=1)
        else:
            r = received.amax(dim=1)
        stats = {
            "gathered_elems": 0.0,
            "exchanged_elems": float(b * (b - 1) * n_local * (nq or 1)),
            "gathered_bytes": 0.0,
            "exchanged_bytes": float(b * (b - 1) * n_local * (nq or 1)
                                     * partials.element_size()),
            "logical_elems": sparse_exchange.count_non_identity(spec, partials),
        }
    elif exchange == "sparse":
        assert capacity is not None, "sparse exchange needs a static capacity"
        r, stats = _compact_exchange(spec, partials, capacity, n_local, scatter, nq)
    elif exchange == "packed":
        assert xchg is not None and xplan is not None, \
            "packed exchange needs the prepare-built index arrays and plan"
        r, stats, shipped = _packed_exchange(spec, partials, xchg, xplan, n_local, scatter,
                                             nq, delta_eps=delta_eps, delta_state=delta_state)
    else:
        raise NotImplementedError(f"exchange={exchange!r} is not supported yet")
    v_new = apply_assign(spec, v_local, r, ctx_local, real_mask)
    if delta_state is not None:
        return v_new, r, stats, shipped
    return v_new, r, stats


def hybrid_step(spec: GimvSpec, sparse_stripe: BlockEdges | None,
                dense_stripe: BlockEdges | None, dense_region: DenseRegion, v_local,
                ctx_local, real_mask, *, n_local: int, capacity: int,
                planned_sparse: FlatPlanned | None = None, dense_matrix=None,
                backend: str = "torch", scatter: str = "segment", exchange: str = "sparse",
                xchg: dict | None = None, xplan=None):
    """Alg. 4: vertical over the sparse region + horizontal over the dense
    region, combined at the owner, then assign.  The dense sub-vector v_d
    is the compacted gather of high-out-degree entries [b, d_cap]; backend
    'planned' runs the dense region through the dense GIM-V kernel on the
    materialized ``dense_matrix`` and the sparse region through the plan.
    The sparse region's partials take the packed exchange when ``exchange``
    is 'packed', else the compact one (hybrid has no dense exchange)."""
    nq = _num_queries(v_local)
    gather_idx = dense_region.gather_idx                           # [b, d_cap]
    if nq is not None:
        gather_idx = gather_idx[:, :, None].expand(-1, -1, nq)
    v_d = torch.gather(v_local, 1, gather_idx)                     # [b, d_cap(, Q)]
    if backend == "planned":
        r_dense = _dense_region_gimv(spec, dense_matrix, v_d, n_local)
        partials = _planned_vertical_partials(spec, planned_sparse, v_local, n_local)
    else:
        r_dense = gathered_gimv(spec, dense_stripe, v_d, n_local)
        partials = block_gimv_partials(spec, sparse_stripe, v_local, n_local)
    if exchange == "packed":
        assert xchg is not None and xplan is not None, \
            "packed exchange needs the prepare-built index arrays and plan"
        r_sparse, stats, _ = _packed_exchange(spec, partials, xchg, xplan, n_local, scatter, nq)
    else:
        r_sparse, stats = _compact_exchange(spec, partials, capacity, n_local, scatter, nq)
    r = combine_elementwise(spec, r_sparse, r_dense)
    v_new = apply_assign(spec, v_local, r, ctx_local, real_mask)
    b = v_local.shape[0]
    d_cap = dense_region.d_cap
    stats["gathered_elems"] = float(b * (b - 1) * d_cap * (nq or 1))
    stats["gathered_bytes"] = float(b * (b - 1) * d_cap * (nq or 1)
                                    * np.dtype(spec.dtype).itemsize)
    return v_new, r, stats
