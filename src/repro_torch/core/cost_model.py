"""PMV I/O cost model (paper §3.4-3.5, Lemmas 3.1-3.3) and the planner's
dimensionless crossovers.

The paper's costs count vector *elements* moved per iteration.  The model
drives three decisions, as in the paper:

1. PMV_selective (Alg. 3): horizontal vs vertical via Eq. 5.
2. θ* for PMV_hybrid: argmin of Lemma 3.3 over candidate thresholds.
3. Capacity sizing of the compacted sparse exchange (Eq. 4 / Eq. 8 x slack).

The per-block crossovers below (``ell_block_cost`` / ``dense_block_cost``,
``prefer_streamed``, ``prefer_kernel_scatter``, ``prefer_packed_exchange``)
are ratios, kept equal to the JAX package's so both packages draw the same
plans.  They were set for the TPU and have not been recalibrated on the H100
yet (ROADMAP).  The planner reads no device rate.  Two rates turn slot costs
and bytes into the modeled seconds the obs layer attaches to launch spans:
``SLOT_TIME_S``, from the H100's data-sheet memory rate, and the JAX
package's modeled disk read rate (``DISK_READ_BW``); both are assumptions,
not measurements.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.stats import GraphStats

__all__ = [
    "horizontal_cost",
    "vertical_cost",
    "hybrid_cost",
    "expected_partial_nnz",
    "expected_sparse_partial_nnz",
    "prefer_horizontal",
    "select_strategy",
    "theta_star",
    "capacity_from_cost_model",
    "ell_block_cost",
    "dense_block_cost",
    "DENSE_SLOT_ADVANTAGE",
    "SLOT_TIME_S",
    "slot_seconds",
    "materialized_partial_elems",
    "streamed_partial_elems",
    "prefer_streamed",
    "kernel_scatter_cost",
    "segment_scatter_cost",
    "prefer_kernel_scatter",
    "PACKED_ID_AMORTIZATION_ITERS",
    "padded_exchange_bytes",
    "packed_exchange_bytes",
    "prefer_packed_exchange",
    "RESIDENCY_MODES",
    "EDGE_SLOT_BYTES",
    "stripe_slice_bytes",
    "disk_block_io_cost",
    "disk_io_seconds",
    "per_host_io_seconds",
    "pipelined_iteration_seconds",
    "predicted_overlap",
]


def _p_empty(b: int, n: int, m: int) -> float:
    """(1 - |M|/|v|^2)^(|v|/b): prob. a vertex has no in-edge from one block."""
    density = m / float(n) ** 2
    if density >= 1.0:
        return 0.0
    return float(np.exp((n / b) * np.log1p(-density)))


def horizontal_cost(b: int, n: int) -> float:
    """Lemma 3.1: E[C_h] = (b+1)|v|."""
    return (b + 1.0) * n


def expected_partial_nnz(b: int, n: int, m: int) -> float:
    """Eq. 4: E[|v^(i,j)|] = (|v|/b) (1 - (1-|M|/|v|^2)^(|v|/b))."""
    return (n / b) * (1.0 - _p_empty(b, n, m))


def vertical_cost(b: int, n: int, m: int) -> float:
    """Lemma 3.2: E[C_v] = 2|v| (1 + (b-1)(1 - (1-|M|/|v|^2)^(|v|/b)))."""
    return 2.0 * n * (1.0 + (b - 1.0) * (1.0 - _p_empty(b, n, m)))


def prefer_horizontal(b: int, n: int, m: int) -> bool:
    """Eq. 5: E[C_h] < E[C_v]  <=>  (1-|M|/|v|^2)^(|v|/b) < 0.5."""
    return _p_empty(b, n, m) < 0.5


def select_strategy(b: int, n: int, m: int) -> str:
    """PMV_selective (Alg. 3)."""
    return "horizontal" if prefer_horizontal(b, n, m) else "vertical"


def expected_sparse_partial_nnz(b: int, n: int, stats: GraphStats, theta: float) -> float:
    """Eq. 8: E[|v_s^(i,j)|] = (|v|/b) Σ_d (1 - (1 - P_out(θ)/b)^d) p_in(d)."""
    p_out = stats.p_out_below(theta)
    degs, p_in = stats.in_degree_hist()
    q = 1.0 - p_out / b
    term = float(np.sum((1.0 - np.power(q, degs)) * p_in))
    return (n / b) * term


def hybrid_cost(b: int, n: int, stats: GraphStats, theta: float) -> float:
    """Lemma 3.3 / Eq. 6:

    E[C_hb] = |v| (P_out(θ) + b (1 - P_out(θ)) + 1)
              + 2|v|(b-1) Σ_d (1 - (1 - P_out(θ)/b)^d) p_in(d)
    """
    p_out = stats.p_out_below(theta)
    degs, p_in = stats.in_degree_hist()
    q = 1.0 - p_out / b
    tail = float(np.sum((1.0 - np.power(q, degs)) * p_in))
    return n * (p_out + b * (1.0 - p_out) + 1.0) + 2.0 * n * (b - 1.0) * tail


def theta_star(
    b: int, n: int, stats: GraphStats, candidates: np.ndarray | None = None
) -> tuple[float, float]:
    """argmin_θ E[C_hb] over candidate thresholds (paper §3.5).  θ=0 is
    horizontal and θ=inf vertical, so both basic methods are candidates.
    Returns (theta, expected_cost)."""
    if candidates is None:
        uniq = stats.out_degree_values().astype(np.float64)
        candidates = np.unique(np.concatenate([[0.0], uniq, uniq + 1.0, [np.inf]]))
    best_theta, best_cost = 0.0, np.inf
    for theta in candidates:
        cost = hybrid_cost(b, n, stats, float(theta))
        if cost < best_cost:
            best_theta, best_cost = float(theta), cost
    return best_theta, best_cost


def capacity_from_cost_model(
    b: int,
    n: int,
    m: int,
    *,
    stats: GraphStats | None = None,
    theta: float | None = None,
    slack: float = 1.5,
) -> int:
    """Cost-model capacity for the compacted exchange (Eq. 4 or Eq. 8 x slack)."""
    if theta is not None and stats is not None:
        exp = expected_sparse_partial_nnz(b, n, stats, theta)
    else:
        exp = expected_partial_nnz(b, n, m)
    return max(1, int(np.ceil(exp * slack)))


# ---------------------------------------------------------------------------
# Per-block tactic costs (planner.py), in units of one ELL slot.
# ---------------------------------------------------------------------------

# One dense-matrix cell costs 1/8 of an ELL slot.  The JAX package's value,
# kept so the two packages plan alike; on the H100 both tactics stream from
# device memory, so this ratio is one of the constants to recalibrate.
DENSE_SLOT_ADVANTAGE = 8.0

# Modeled wall seconds per slot unit, the JAX package's formula: one gather /
# ELL slot streams 8 B from device memory.  Over the H100 SXM's data-sheet
# 3.35 TB/s HBM3 that is ~2.39e-12 s: a data-sheet anchor for the card, not
# a measurement.  It only sets ``predicted_s`` on the obs layer's launch
# spans; the measured / predicted residuals (repro_torch.obs.report) are the
# correction a calibration would fold back in.
SLOT_TIME_S = 8.0 / 3.35e12


def slot_seconds(cost_slots: float) -> float:
    """Model time for ``cost_slots`` slot units of tactic compute (the
    predicted_s attached to launch spans by the obs layer)."""
    return cost_slots * SLOT_TIME_S


def ell_block_cost(bucketed_slots: int) -> float:
    """Per-iteration cost of an ell-tactic block = the padded slots its
    row-bucketed ELL slices touch."""
    return float(bucketed_slots)


def dense_block_cost(n_local: int, advantage: float = DENSE_SLOT_ADVANTAGE) -> float:
    """Per-iteration cost of a dense-tactic block: all n_local^2 cells, each
    1/advantage of an ELL slot."""
    return n_local * n_local / advantage


# ---------------------------------------------------------------------------
# Streamed vs materialized planned execution (ExecutionPlan.stream).
# ---------------------------------------------------------------------------

# Minimum live-memory reduction factor before the planner trades the fused
# launch schedule for the b-step streamed schedule.
STREAM_MIN_SAVINGS = 2.0


def materialized_partial_elems(b: int, n_local: int) -> int:
    """Live partial-buffer elements per worker of the fused planned executor."""
    return b * n_local


def streamed_partial_elems(b: int, n_local: int, capacity: int) -> int:
    """Live partial-buffer elements per worker of the streamed executor: one
    [n_local] partial in flight + the fixed [b, cap] exchange buffer."""
    return n_local + b * min(capacity, n_local)


def prefer_streamed(b: int, n_local: int, capacity: int) -> bool:
    """stream='auto' crossover: stream only when the materialized buffer is
    at least STREAM_MIN_SAVINGS x the streamed profile."""
    mat = materialized_partial_elems(b, n_local)
    return mat >= STREAM_MIN_SAVINGS * streamed_partial_elems(b, n_local, capacity)


# ---------------------------------------------------------------------------
# Receive-side scatter tactic (ExecutionPlan.scatter): T received slots
# through the scatter-combine kernel vs T serial segment-op writes.  The
# ratios are the JAX package's; ``interpret`` marks a host that runs the
# kernels' plain versions, where the segment op always wins.
# ---------------------------------------------------------------------------

SERIAL_SCATTER_SLOT_COST = 16.0
INTERPRET_SLOT_PENALTY = 64.0


def kernel_scatter_cost(t: float, n_out: int, *, interpret: bool = False,
                        advantage: float = DENSE_SLOT_ADVANTAGE) -> float:
    """Scatter-combine kernel cost in the JAX package's model: T x n_out
    slots at 1/advantage each."""
    adv = advantage / INTERPRET_SLOT_PENALTY if interpret else advantage
    return t * n_out / adv


def segment_scatter_cost(t: float) -> float:
    """Segment-op cost: T serial random-access scatter writes."""
    return t * SERIAL_SCATTER_SLOT_COST


def prefer_kernel_scatter(t: float, n_out: int, *, interpret: bool = False) -> bool:
    """scatter='auto' crossover."""
    return kernel_scatter_cost(t, n_out, interpret=interpret) < segment_scatter_cost(t)


# ---------------------------------------------------------------------------
# Packed-exchange transport (repro_torch.exchange).  The compact sparse
# exchange re-ships an int32 index for every capacity slot every iteration;
# the packed exchange derives the per-(src, dst) index sets once at prepare
# time, ships the packed ids a single time and then streams only payloads:
#   padded:  b(b-1) * capacity * (4 + q*itemsize)          per iteration
#   packed:  payload_slots * q * itemsize                  per iteration
#            + id_bytes / PACKED_ID_AMORTIZATION_ITERS     (one-time, amortized)
# The constant is the JAX package's, so exchange='auto' decides as it does.
# ---------------------------------------------------------------------------

PACKED_ID_AMORTIZATION_ITERS = 10.0


def padded_exchange_bytes(b: int, capacity: int, nq: int | None,
                          itemsize: int) -> float:
    """Per-iteration wire bytes of the capacity-padded (idx, val) exchange
    (the byte model of ``sparse_exchange.exchange_wire_bytes``)."""
    return float(b * (b - 1) * capacity * (4 + (nq or 1) * itemsize))


def packed_exchange_bytes(payload_slots: int, nq: int | None,
                          itemsize: int) -> float:
    """Per-iteration wire bytes of the packed exchange's payload stream (the
    static ids ship once and are amortized separately)."""
    return float(payload_slots * (nq or 1) * itemsize)


def prefer_packed_exchange(b: int, capacity: int, payload_slots: int, id_bytes: int,
                           nq: int | None, itemsize: int, *,
                           amortization_iters: float = PACKED_ID_AMORTIZATION_ITERS) -> bool:
    """exchange='auto' gate: take the packed transport when its amortized
    per-iteration bytes undercut the padded stream's."""
    padded = padded_exchange_bytes(b, capacity, nq, itemsize)
    packed = (packed_exchange_bytes(payload_slots, nq, itemsize)
              + id_bytes / amortization_iters)
    return packed < padded


# ---------------------------------------------------------------------------
# Disk-residency I/O leg.  residency='disk' keeps the pre-partitioned shards
# on disk and streams one block's slices per launch-schedule step, so every
# non-skip block pays a read of its padded e_cap slots on top of its compute
# tactic.  The constants are the JAX package's, so both packages plan alike.
# ---------------------------------------------------------------------------

RESIDENCY_MODES = ("device", "host", "disk")

# Bytes per padded edge slot in a shard slice: int32 seg + int32 gat + f32 w.
EDGE_SLOT_BYTES = 12

# The JAX package's modeled sequential read rate of the shard files
# (NVMe-class), used only to print a modeled time beside a plan.
DISK_READ_BW = 2e9  # B/s

# One ELL compute slot expressed in streamed disk bytes (the JAX package's
# ratio): the planner charges each non-skip block e_cap * slot bytes / 32.
DISK_SLOT_BYTES_EQUIV = 32.0


def _slot_bytes(has_w: bool) -> int:
    """Bytes per padded edge slot: EDGE_SLOT_BYTES with the f32 weight array
    (recomputed when fetched, never stored), the int32 seg + gat pair
    without."""
    return EDGE_SLOT_BYTES if has_w else EDGE_SLOT_BYTES - 4


def stripe_slice_bytes(workers: int, e_cap: int, *, has_w: bool = False) -> int:
    """Bytes of ONE destination (or source) block's shard slice across all
    workers: [workers, e_cap] seg + gat plus the counts; ``has_w=True`` adds
    the recomputed f32 weights (resident bytes, the budget's measure, not
    bytes read)."""
    return workers * (e_cap * _slot_bytes(has_w) + 4)


def disk_block_io_cost(e_cap: int, *, has_w: bool = False) -> float:
    """Slot-unit cost of streaming one block's shard slice per iteration
    (added to every non-skip tactic cost under residency='disk')."""
    return e_cap * _slot_bytes(has_w) / DISK_SLOT_BYTES_EQUIV


def disk_io_seconds(bytes_read: float) -> float:
    """Modeled time for reading ``bytes_read`` shard bytes at DISK_READ_BW."""
    return bytes_read / DISK_READ_BW


def per_host_io_seconds(bytes_read: float, workers: int) -> float:
    """Modeled time for the disk leg split across ``workers`` hosts, each
    streaming its own stripe range from its own disk at once: the critical
    path is one host's share of ``bytes_read``.  One card is one worker."""
    if workers <= 0:
        raise ValueError(f"workers must be positive, got {workers}")
    return disk_io_seconds(bytes_read / workers)


def pipelined_iteration_seconds(io_s: float, wire_s: float, compute_s: float) -> float:
    """Modeled wall time of one pipelined out-of-core iteration: the
    prefetch pipeline overlaps the disk leg with exchange + compute, so the
    iteration costs the larger of the two legs."""
    return max(io_s, wire_s + compute_s)


def predicted_overlap(io_s: float, wire_s: float, compute_s: float) -> float:
    """Modeled share of the disk time the pipeline hides (the counterpart of
    the measured ``store_overlap``): exchange + compute cover that much of
    the I/O leg."""
    if io_s <= 0.0:
        return 1.0
    return max(0.0, min(1.0, (wire_s + compute_s) / io_s))
