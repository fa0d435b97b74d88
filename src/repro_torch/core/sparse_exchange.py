"""Compacted sparse exchange for PMV_vertical / PMV_hybrid.

The vertical placement ships only the non-empty entries of each partial
result v^(i,j) (that is where its I/O win over horizontal comes from,
Lemma 3.2).  Each partial row [n_local] is compacted into (idx, val) pairs
of a static ``capacity``: the structural max partial nnz computed at
partition time, so overflow cannot occur.

Compaction ('scan'): each valid entry's output slot is the count of valid
entries before it, so every compacted row holds strictly ascending unique
indices, padded with ``n_local``.  The scatter-combine kernel relies on that
layout.  The inverse (:func:`scatter_partials`) folds the received rows into
the owner's result with combineAll.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.core.gimv import GimvSpec, segment_combine

__all__ = ["compact_partials", "compact_chunk", "scatter_partials",
           "count_non_identity", "exchange_wire_bytes", "exchange_wire_split",
           "SCATTER_METHODS"]

SCATTER_METHODS = ("segment", "kernel")


def exchange_wire_bytes(b: int, capacity: int, nq: int | None,
                        payload_itemsize: int) -> float:
    """Static wire bytes of one compact exchange round across all workers:
    b(b-1) shipped [capacity] slices, each slot an int32 index plus (1 or Q)
    payload values."""
    return float(b * (b - 1) * capacity * (4 + (nq or 1) * payload_itemsize))


def exchange_wire_split(b: int, capacity: int, nq: int | None,
                        payload_itemsize: int) -> tuple[float, float]:
    """``exchange_wire_bytes`` split into its (id_bytes, payload_bytes) legs."""
    id_bytes = float(b * (b - 1) * capacity * 4)
    payload_bytes = float(b * (b - 1) * capacity * (nq or 1) * payload_itemsize)
    return id_bytes, payload_bytes


def count_non_identity(spec: GimvSpec, partials: torch.Tensor) -> torch.Tensor:
    """Number of logically transferred elements (paper's I/O accounting)."""
    return (partials != spec.identity).sum().to(torch.float32)


def _compact_idx_scan(valid: torch.Tensor, capacity: int, n_local: int) -> torch.Tensor:
    """First ``capacity`` valid indices per row via cumsum-prefix scatter:
    each valid entry's slot is the count of valid entries before it; slots
    >= capacity land in a drop bucket that is sliced off."""
    lead = valid.shape[:-1]
    rows = math.prod(lead) if lead else 1
    dev = valid.device
    pos = torch.cumsum(valid.to(torch.int32), dim=-1) - 1
    dest = torch.where(valid & (pos < capacity), pos, capacity).reshape(rows, n_local)
    flat = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None] * (capacity + 1)
            + dest)
    src = torch.arange(n_local, dtype=torch.int32, device=dev).expand(rows, n_local)
    out = torch.full((rows * (capacity + 1),), n_local, dtype=torch.int32, device=dev)
    # Valid slots are unique per row; only the drop bucket takes duplicates,
    # and it is sliced off below.
    out.scatter_(0, flat.reshape(-1), src.reshape(-1))
    return out.reshape(rows, capacity + 1)[:, :capacity].reshape(lead + (capacity,))


def compact_partials(spec: GimvSpec, partials: torch.Tensor, capacity: int, axis=None, *,
                     batched: bool = False):
    """[..., b, n_local] -> idx [..., b, cap] int32, val [..., b, cap].

    idx == n_local marks padding; entries equal to the combineAll identity
    are dropped (they are no-ops under combineAll).  Returns (idx, val,
    overflow_rows, logical_elems), the counters as float32 scalars summed
    over the worker ``axis`` (a ``collectives.WorkerAxis``) when one is given.

    batched=True: partials carry a trailing query axis [..., n_local, Q] and
    each partial row keeps ONE index set shared by its Q columns: an entry is
    kept when it is not the identity in any column, and val [..., b, cap, Q]
    takes all Q values with it (the wire format (idx, val[Q])).  overflow
    counts rows; logical_elems counts every non-identity scalar.
    """
    ident = spec.identity
    valid_q = partials != ident
    valid = valid_q.any(dim=-1) if batched else valid_q
    n_local = valid.shape[-1]
    capacity = min(capacity, n_local)
    idx = _compact_idx_scan(valid, capacity, n_local)
    taken = idx < n_local
    safe = torch.where(taken, idx, 0).to(torch.int64)
    fill = torch.full((), ident, dtype=partials.dtype, device=partials.device)
    if batched:
        # one row gather per kept index: [rows * n_local, Q] -> [rows * cap, Q]
        nq = partials.shape[-1]
        rows = valid.numel() // n_local
        base = torch.arange(rows, dtype=torch.int64, device=partials.device)[:, None] * n_local
        flat = (safe.reshape(rows, capacity) + base).reshape(-1)
        val = partials.reshape(rows * n_local, nq).index_select(0, flat)
        val = val.masked_fill_(~taken.reshape(-1, 1), fill).reshape(idx.shape + (nq,))
    else:
        val = torch.where(taken, torch.gather(partials, -1, safe), fill)
    counts = valid.sum(dim=-1)
    # exact integer counts, reported as float32 (no float copy of the masks)
    overflow = collectives.psum((counts > capacity).sum(), axis).to(torch.float32)
    logical = collectives.psum(valid_q.sum(), axis).to(torch.float32)
    return idx, val, overflow, logical


def compact_chunk(spec: GimvSpec, partial: torch.Tensor, capacity: int, *,
                  batched: bool = False):
    """Compaction of ONE destination block's partial chunk [..., n_local(, Q)]
    (the streamed planned executor's per-block step); per-row compaction is
    independent, so compacting chunk by chunk gives the same buffers as one
    :func:`compact_partials` over the stacked partials, and the counters
    summed over the chunks equal its counters.  They are this rank's: the
    caller reduces the sums over the worker axis."""
    return compact_partials(spec, partial, capacity, batched=batched)


def scatter_partials(spec: GimvSpec, idx: torch.Tensor, val: torch.Tensor,
                     n_local: int, *, method: str = "segment") -> torch.Tensor:
    """combineAll of received compact partials: [..., b, cap] x2 -> r [..., n_local].

    A trailing query axis on ``val`` ([..., b, cap, Q] with idx [..., b, cap])
    combines columnwise and returns r [..., n_local, Q].

    method 'segment': segment-combine over the flattened rows, each set offset
    into its own (n_local + 1)-wide output segment whose last slot catches
    the padding.  method 'kernel': the scatter-combine kernel (its Q-wide
    form for a batched val), which folds the b received rows of each set in
    order (idx must be the compacted layout of :func:`compact_partials`);
    inside ``kernels.plain_versions`` its plain version.
    """
    assert method in SCATTER_METHODS, method
    batched = val.ndim == idx.ndim + 1
    tail = tuple(val.shape[idx.ndim:])
    lead = idx.shape[:-2]
    n_sets = math.prod(lead) if lead else 1
    if method == "kernel":
        from repro_torch.kernels import runs_plain
        from repro_torch.kernels.block_gimv import semiring_of
        from repro_torch.kernels.scatter_combine import (scatter_combine_gimv,
                                                         scatter_combine_gimv_multi,
                                                         scatter_combine_multi_ref,
                                                         scatter_combine_ref)

        if runs_plain(val.device):
            fn = scatter_combine_multi_ref if batched else scatter_combine_ref
        else:
            fn = scatter_combine_gimv_multi if batched else scatter_combine_gimv
        out = fn(idx.reshape((n_sets,) + idx.shape[-2:]).contiguous(),
                 val.reshape((n_sets,) + val.shape[-2 - len(tail):]).contiguous(),
                 n_local, semiring=semiring_of(spec.combine2, spec.combine_all))
        return out.reshape(lead + (n_local,) + tail)
    seg_w = n_local + 1
    idx2 = idx.reshape(n_sets, -1).to(torch.int64)
    off = torch.arange(n_sets, dtype=torch.int64, device=idx.device)[:, None] * seg_w
    flat_idx = (idx2 + off).reshape(-1)
    out = segment_combine(spec, val.reshape((flat_idx.shape[0],) + tail), flat_idx,
                          n_sets * seg_w)
    out = out.reshape(lead + (seg_w,) + tail)
    return out[..., :n_local, :] if batched else out[..., :n_local]
