"""Device-side primitives of the packed exchange (send gather, receive
scatter, delta suppression).  The workers are a leading axis: all b of them
in emulation, this rank's one under a worker ``axis``
(``repro_torch.core.collectives.WorkerAxis``), where the counts are summed
over the axis.

The sender gathers its partials at the static per-pair row order
(``send_rows``) -- no per-iteration compaction, no overflow (the index sets
ARE the structural support).  The receiver scatters the arriving payload at
the mirrored ``recv_rows`` (method 'segment'), or decodes the bit-packed
``recv_words`` inside the packed scatter-combine kernel (method 'kernel').
Delta iteration keeps the previously-sent payload as carried state and
re-sends only rows whose value moved beyond eps; for eps=0 the "stale" rows
are bitwise the current ones, so the receive is exact.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import collectives
from repro_torch.core.gimv import GimvSpec
from repro_torch.core.sparse_exchange import scatter_partials

__all__ = ["gather_payload", "scatter_payload", "payload_logical", "delta_update",
           "pair_slot_mask"]


def gather_payload(spec: GimvSpec, partials: torch.Tensor,
                   send_rows: torch.Tensor) -> torch.Tensor:
    """Gather partials [..., b, n_local(, Q)] at send_rows [..., b, p] ->
    payload [..., b, p(, Q)].  Sentinel slots (row >= n_local) yield the
    combineAll identity, so the receive's drop slot sees exact no-ops."""
    batched = partials.ndim == send_rows.ndim + 1
    n_local = partials.shape[-2] if batched else partials.shape[-1]
    pad = send_rows >= n_local
    safe = torch.where(pad, 0, send_rows).to(torch.int64)
    ident = torch.full((), spec.identity, dtype=partials.dtype, device=partials.device)
    if not batched:
        return torch.where(pad, ident, torch.gather(partials, -1, safe))
    # one row gather per slot: [rows * n_local, Q] -> [rows * p, Q]
    nq = partials.shape[-1]
    rows = math.prod(send_rows.shape[:-1])
    base = torch.arange(rows, dtype=torch.int64, device=partials.device)[:, None] * n_local
    flat = (safe.reshape(rows, -1) + base).reshape(-1)
    val = partials.reshape(rows * n_local, nq).index_select(0, flat)
    return val.masked_fill_(pad.reshape(-1, 1), ident).reshape(send_rows.shape + (nq,))


def payload_logical(spec: GimvSpec, payload: torch.Tensor, axis=None) -> torch.Tensor:
    """Value-level non-identity count of a payload -- equal to the sparse
    path's ``logical_elems``, because the structural row sets cover exactly
    the slots a value-compacted exchange could ship."""
    return collectives.psum((payload != spec.identity).sum(), axis).to(torch.float32)


def scatter_payload(spec: GimvSpec, val: torch.Tensor, n_local: int, *,
                    recv_rows: torch.Tensor | None = None,
                    recv_words: torch.Tensor | None = None, p_dev: int = 0,
                    width: int = 0, method: str = "segment") -> torch.Tensor:
    """combineAll of received payloads val [..., b, p(, Q)] -> r [..., n_local(, Q)].

    method='segment' scatters at the int32 ``recv_rows`` (sentinel rows land
    in the per-set drop slot, exactly like ``scatter_partials``).
    method='kernel' with ``recv_words`` ([..., W] uint32, each set's words in
    sender order) decodes the bit-packed ids inside the packed scatter-combine
    kernel -- the ids never exist as int32 on the device; without
    ``recv_words`` it takes the sparse scatter-combine kernel on
    ``recv_rows``.
    """
    if method == "kernel" and recv_words is not None:
        from repro_torch.kernels.block_gimv import semiring_of
        from repro_torch.kernels.scatter_combine import (packed_scatter_combine_gimv,
                                                         packed_scatter_combine_gimv_multi)

        batched = (val.ndim - recv_words.ndim) == 2
        nq = val.shape[-1] if batched else None
        lead = val.shape[:-3] if batched else val.shape[:-2]
        b = val.shape[-3] if batched else val.shape[-2]
        n_sets = math.prod(lead) if lead else 1
        seg_w = n_local + 1
        set_slots = b * p_dev            # slots sharing one worker's output segment
        flat_val = val.reshape((n_sets * set_slots, nq) if batched else (-1,)).contiguous()
        fn = packed_scatter_combine_gimv_multi if batched else packed_scatter_combine_gimv
        out = fn(recv_words.reshape(-1).contiguous(), flat_val, n_sets * seg_w,
                 set_slots=set_slots, n_local=n_local, width=width,
                 semiring=semiring_of(spec.combine2, spec.combine_all), senders=b)
        out = out.reshape(lead + ((seg_w, nq) if batched else (seg_w,)))
        return out[..., :n_local, :] if batched else out[..., :n_local]
    return scatter_partials(spec, recv_rows, val, n_local, method=method)


def pair_slot_mask(send_rows: torch.Tensor, n_local: int, axis=None) -> torch.Tensor:
    """Bool [b_w, b, p]: slots that count toward wire accounting -- valid
    (non-sentinel) rows of OFF-DIAGONAL pairs (the diagonal partial never
    crosses the interconnect; both the padded formula and the packed byte
    model are b(b-1) quantities).  The leading rows are the workers from
    this rank's index on (0 in emulation)."""
    valid = send_rows < n_local
    b_w, b = send_rows.shape[0], send_rows.shape[-2]
    dev = send_rows.device
    src = torch.arange(b_w, device=dev) + collectives.axis_index(axis)
    off = src[:, None] != torch.arange(b, device=dev)[None, :]
    return valid & off[..., None]


def delta_update(spec: GimvSpec, payload: torch.Tensor, prev: torch.Tensor, eps: float,
                 pair_mask: torch.Tensor, axis=None):
    """Suppress rows whose payload moved <= eps since the last send.

    Returns (shipped, sent_rows, suppressed_rows), the counts float32 scalar
    tensors.  ``shipped`` carries the fresh payload on rows that moved and
    the previously-sent value elsewhere (the receiver-side cache, folded into
    the stream so the scatter stays oblivious).  eps=0 compares with ``!=``
    -- bitwise exact, and immune to the inf - inf = NaN trap of an |diff|
    test.  A trailing query axis re-sends a row when ANY query moved (one
    shared send mask per row keeps the id-free wire order intact).
    """
    batched = payload.ndim == pair_mask.ndim + 1
    if eps == 0.0:
        changed = payload != prev
    else:
        changed = (payload - prev).abs() > eps
    if batched:
        changed = changed.any(dim=-1)
    shipped = torch.where(changed[..., None] if batched else changed, payload, prev)
    sent = collectives.psum((changed & pair_mask).sum(), axis).to(torch.float32)
    total = collectives.psum(pair_mask.sum(), axis).to(torch.float32)
    return shipped, sent, total - sent
