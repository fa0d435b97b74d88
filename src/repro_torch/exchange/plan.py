"""Static exchange plan: per-(src, dst) block index sets + byte accounting
(numpy; this package's own copy of the JAX package's ``repro.exchange.plan``,
reading this package's host ``BlockEdges``).

``build_exchange`` runs once at ``prepare()`` time.  It derives, for every
(destination block i, source block j) pair, the deduplicated sorted set of
destination-local rows block M^(i,j) can touch — static across iterations
because the matrix structure never changes — and materializes:

- ``send_rows`` [b_src, b_dst, p_dev] int32: worker j's gather order for the
  payload it ships to each destination (pad slots carry the sentinel
  ``n_local``).
- ``recv_rows`` = swapaxes(send_rows, 0, 1): worker i's scatter targets for
  each arriving payload (sentinel rows land in the per-set drop slot).
- ``recv_words`` (scatter='kernel' only) [b_dst, W] uint32: the same recv
  sets bit-packed at a uniform width so the packed scatter-combine kernel
  decodes them in registers instead of reading int32 rows.

The :class:`ExchangePlan` summary is a frozen (hashable) dataclass of the
static byte model -- it rides inside ``StepConfig`` so each step reads the
constants of its stats from it, and ``format_exchange`` renders it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.exchange import codec

__all__ = [
    "ExchangePlan",
    "row_sets_from_stripes",
    "row_sets_from_nnz_template",
    "build_exchange",
    "summarize_row_sizes",
    "format_exchange",
]


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static summary of one packed-exchange layout (hashable)."""

    b: int
    n_local: int
    p_cap: int          # max index-set size over all (i, j) pairs
    p_dev: int          # word-aligned device slot capacity (>= p_cap)
    width_dev: int      # uniform device bit width (4/8/16/32)
    payload_slots: int  # sum of off-diagonal index-set sizes = values/iter
    id_bytes: int       # one-time wire bytes for all off-diagonal id sets
    bitmap_bytes: int   # per-iteration delta send-mask bytes (off-diagonal)
    pair_rows: tuple    # b*b row-major (dst i, src j) index-set sizes
    pair_widths: tuple  # b*b row-major wire-codec bit widths

    def rows_of(self, i: int, j: int) -> int:
        return self.pair_rows[i * self.b + j]

    def width_of(self, i: int, j: int) -> int:
        return self.pair_widths[i * self.b + j]

    def payload_bytes_per_iter(self, nq: int | None, itemsize: int) -> float:
        """Full-stream (non-delta) payload bytes per iteration."""
        return float(self.payload_slots * (nq or 1) * itemsize)


def row_sets_from_stripes(stripes: list, b: int) -> list:
    """Per-pair sorted unique destination rows from vertical stripes.

    ``stripes[j]`` is source worker j's BlockEdges (seg_local [b, e_cap],
    count [b]); returns ``rows[i][j]`` int64 arrays.
    """
    rows = [[None] * b for _ in range(b)]
    for j, stripe in enumerate(stripes):
        seg = np.asarray(stripe.seg_local)
        cnt = np.asarray(stripe.count)
        for i in range(b):
            c = int(cnt[i])
            rows[i][j] = (np.unique(seg[i, :c]).astype(np.int64) if c
                          else np.zeros(0, np.int64))
    return rows


def row_sets_from_nnz_template(partial_nnz: np.ndarray) -> list:
    """Index-set SIZES only (no ids) — enough for the byte model when the
    stripes are not resident (explain() on a sparse-mode prepare)."""
    b = partial_nnz.shape[0]
    return [[int(partial_nnz[i, j]) for j in range(b)] for i in range(b)]


def check_sorted_rows(rows: np.ndarray, n_local: int) -> None:
    """Raise ValueError unless every row of ``rows`` ([..., p]) is a strictly
    ascending run of ids in [0, n_local) followed only by the sentinel
    n_local: the layout the packed scatter-combine kernel searches."""
    rows = np.asarray(rows, np.int64)
    valid = (rows >= 0) & (rows < n_local)
    if np.any((rows < 0) | ((rows >= n_local) & (rows != n_local))):
        raise ValueError(f"row ids must lie in [0, {n_local}] (n_local is the sentinel)")
    if np.any(~valid[..., :-1] & valid[..., 1:]):
        raise ValueError("an id follows the sentinel in a row")
    if np.any(np.diff(rows, axis=-1)[valid[..., :-1] & valid[..., 1:]] <= 0):
        raise ValueError("row ids are not strictly ascending")


def build_exchange(
    row_sets: list,
    n_local: int,
    *,
    scatter: str = "segment",
) -> tuple[ExchangePlan, dict]:
    """Build the device arrays + static plan from per-pair row sets.

    Returns ``(plan, arrays)`` where arrays holds numpy tensors (the engine
    copies them to its device into the matrix dict):
      send_rows [b, b, p_dev] int32, indexed [src worker j, dst block i, slot]
      recv_rows [b, b, p_dev] int32, indexed [dst worker i, src block j, slot]
      recv_words [b, W] uint32 (only when scatter='kernel')
    """
    b = len(row_sets)
    pair_rows = np.zeros((b, b), np.int64)
    pair_widths = np.zeros((b, b), np.int64)
    id_bytes = 0
    bitmap_bytes = 0
    for i in range(b):
        for j in range(b):
            ids = row_sets[i][j]
            packed = codec.pack_ids(ids, n_local)
            pair_rows[i, j] = packed.count
            pair_widths[i, j] = packed.width
            if i != j:
                id_bytes += codec.packed_nbytes(packed)
                bitmap_bytes += -(-packed.count // 8)
    p_cap = max(int(pair_rows.max()), 1)
    width_dev = codec.device_width(n_local)
    ids_per_word = 32 // width_dev
    p_dev = -(-p_cap // ids_per_word) * ids_per_word

    send_rows = np.full((b, b, p_dev), n_local, np.int32)
    for i in range(b):
        for j in range(b):
            ids = row_sets[i][j]
            send_rows[j, i, : len(ids)] = ids
    recv_rows = np.ascontiguousarray(send_rows.swapaxes(0, 1))

    arrays = {"send_rows": send_rows, "recv_rows": recv_rows}
    if scatter == "kernel":
        # The packed kernel searches each sender row: check the order it needs.
        check_sorted_rows(recv_rows, n_local)
        # Per receiving worker: its b sets' words concatenated in set order.
        arrays["recv_words"] = codec.pack_uniform(
            recv_rows, width_dev).reshape(b, -1)

    off = ~np.eye(b, dtype=bool)
    plan = ExchangePlan(
        b=b,
        n_local=int(n_local),
        p_cap=p_cap,
        p_dev=int(p_dev),
        width_dev=width_dev,
        payload_slots=int(pair_rows[off].sum()),
        id_bytes=int(id_bytes),
        bitmap_bytes=int(bitmap_bytes),
        pair_rows=tuple(int(x) for x in pair_rows.reshape(-1)),
        pair_widths=tuple(int(x) for x in pair_widths.reshape(-1)),
    )
    return plan, arrays


def summarize_row_sizes(row_sets: list, n_local: int) -> ExchangePlan:
    """ExchangePlan byte model from index-set SIZES alone (``row_sets[i][j]``
    ints).  Wire widths are upper-bounded by the uniform-spacing delta width,
    so id_bytes is an estimate — used only for explain() previews when the
    packed arrays were not built."""
    b = len(row_sets)
    pair_rows = np.zeros((b, b), np.int64)
    pair_widths = np.zeros((b, b), np.int64)
    id_bytes = 0
    bitmap_bytes = 0
    for i in range(b):
        for j in range(b):
            c = int(row_sets[i][j])
            pair_rows[i, j] = c
            if c:
                # worst-case delta for c sorted ids in [0, n_local)
                gap = max(1, n_local - c + 1)
                pair_widths[i, j] = max(1, int(gap).bit_length())
            if i != j:
                nwords = -(-c * int(pair_widths[i, j]) // 32)
                id_bytes += codec.HEADER_BYTES + 4 * nwords
                bitmap_bytes += -(-c // 8)
    p_cap = max(int(pair_rows.max()), 1)
    width_dev = codec.device_width(n_local)
    ids_per_word = 32 // width_dev
    off = ~np.eye(b, dtype=bool)
    return ExchangePlan(
        b=b, n_local=int(n_local), p_cap=p_cap,
        p_dev=-(-p_cap // ids_per_word) * ids_per_word,
        width_dev=width_dev,
        payload_slots=int(pair_rows[off].sum()),
        id_bytes=int(id_bytes),
        bitmap_bytes=int(bitmap_bytes),
        pair_rows=tuple(int(x) for x in pair_rows.reshape(-1)),
        pair_widths=tuple(int(x) for x in pair_widths.reshape(-1)),
    )


def format_exchange(
    xplan: ExchangePlan,
    *,
    mode: str,
    decision: str,
    capacity: int,
    itemsize: int,
    nq: int | None = None,
    delta_eps: float | None = None,
    estimated: bool = False,
) -> str:
    """Human-readable exchange section for ``explain()``."""
    from repro_torch.core import cost_model  # local import: core imports us too

    b = xplan.b
    padded = cost_model.padded_exchange_bytes(b, capacity, nq, itemsize)
    packed = xplan.payload_bytes_per_iter(nq, itemsize)
    amort = xplan.id_bytes / cost_model.PACKED_ID_AMORTIZATION_ITERS
    rows = np.asarray(xplan.pair_rows).reshape(b, b)
    widths = np.asarray(xplan.pair_widths).reshape(b, b)
    off = ~np.eye(b, dtype=bool)
    lines = [
        "exchange:",
        f"  mode                 {mode} ({decision})",
        f"  index sets           {b}x{b} pairs, p_cap={xplan.p_cap} "
        f"p_dev={xplan.p_dev} dev_width={xplan.width_dev}b"
        + (" [estimated]" if estimated else ""),
        f"  id bytes (once)      {xplan.id_bytes:,} "
        f"(~{amort:,.0f}/iter over {cost_model.PACKED_ID_AMORTIZATION_ITERS:.0f} iters)",
        f"  payload bytes/iter   packed {packed:,.0f} vs padded {padded:,.0f}",
    ]
    if delta_eps is not None:
        lines.append(
            f"  delta iteration      eps={delta_eps:g} "
            f"(+{xplan.bitmap_bytes:,} bitmap bytes/iter, payload decays)")
    if off.any():
        r = rows[off]
        w = widths[off]
        lines.append(
            f"  off-diag set sizes   min={int(r.min())} "
            f"med={int(np.median(r))} max={int(r.max())}  "
            f"wire widths {int(w.min())}-{int(w.max())}b")
    if b <= 8:
        lines.append("  per-pair rows (dst i x src j):")
        for i in range(b):
            cells = " ".join(f"{int(rows[i, j]):>7d}" for j in range(b))
            lines.append(f"    i={i}  {cells}")
    return "\n".join(lines)
