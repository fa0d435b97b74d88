"""Per-block execution planner: the density-driven ExecutionPlan.

At ``PMVEngine.prepare()`` time every b x b sub-block M^(i,j) is measured
(nnz, max in-degree, flat-ELL occupancy) and classified with the cost model
(cost_model.ell_block_cost / dense_block_cost) into a tactic:

    skip  -- structurally empty: dropped at pack time;
    ell   -- the ELL GIM-V kernel over ROW-BUCKETED ELL slices (degree
             buckets with power-of-two widths);
    dense -- a near-dense block materialized as a [n_local, n_local]
             semiring matrix for the dense GIM-V kernel.

The plan is frozen and hashable; ``blocks.pack_planned_stripe`` packs
against it and the ``placement._planned_*`` executors run it with fused
same-tactic launches.  It also carries the receive-side tactic of the
sparse exchange (``scatter``: 'segment' or 'kernel') and the partial-vector
schedule (``stream``; this package runs 'off' only).  Tactic tables equal
the JAX package's for the same graph and knobs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.blocks import BlockEdges
from repro_torch.core.sparse_exchange import SCATTER_METHODS

__all__ = [
    "BlockPlan",
    "ExecutionPlan",
    "bucket_boundaries",
    "measure_blocks",
    "plan_execution",
    "format_plan",
    "TACTICS",
    "MODES",
    "STREAM_MODES",
]

TACTICS = ("skip", "ell", "dense")
MODES = ("torch", "planned")
STREAM_MODES = ("on", "off")


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Measured stats + chosen tactic for one pre-partitioned sub-block."""

    i: int               # destination (segment) block
    j: int               # source (gather) block
    tactic: str          # 'skip' | 'ell' | 'dense'
    nnz: int             # edges in M^(i,j)
    rows: int            # destination rows with >= 1 edge
    d_max: int           # max in-degree within the block
    occupancy: float     # nnz / (rows * d_max): flat-ELL slot occupancy
    cost: float          # predicted per-iteration compute cost (slot units)
    bucket_rows: tuple[int, ...] = ()  # rows per ELL degree bucket (ell tactic)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Static, hashable execution plan for one prepared solve.  mode
    'planned' runs the per-block tactics; 'torch' records the plain-tensor
    backend (its executor ignores the tactic table)."""

    strategy: str                   # 'horizontal' | 'vertical' | 'hybrid'
    mode: str                       # 'torch' | 'planned'
    b: int
    n_local: int
    theta: float | None
    capacity: int | None
    boundaries: tuple[int, ...]     # bucket width boundaries (ascending)
    blocks: tuple[BlockPlan, ...]   # b*b entries, row-major (i, j)
    scatter: str = "segment"        # receive-side tactic: 'segment' | 'kernel'
    stream: str = "off"             # partial schedule

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.scatter in SCATTER_METHODS, self.scatter
        assert self.stream in STREAM_MODES, self.stream
        assert len(self.blocks) == self.b * self.b, (len(self.blocks), self.b)

    def block(self, i: int, j: int) -> BlockPlan:
        return self.blocks[i * self.b + j]

    def tactics_for_worker(self, worker: int, layout: str) -> tuple[str, ...]:
        """Per-inner-block tactics of one worker's stripe.  layout='vertical':
        worker j owns blocks (i, j); layout='merged': worker i owns (i, jj)."""
        if layout == "vertical":
            return tuple(self.block(i, worker).tactic for i in range(self.b))
        return tuple(self.block(worker, jj).tactic for jj in range(self.b))

    def tactic_counts(self) -> dict[str, int]:
        out = {t: 0 for t in TACTICS}
        for bp in self.blocks:
            out[bp.tactic] += 1
        return out

    @property
    def flat_padded_slots(self) -> int:
        """Slots a flat layout touches: every non-empty block's rows padded to
        the stripe-global d_cap."""
        d_cap = max((bp.d_max for bp in self.blocks), default=1)
        return sum(bp.rows * d_cap for bp in self.blocks if bp.nnz)

    @property
    def planned_slots(self) -> float:
        """Predicted slots under the plan (sum of per-block tactic costs)."""
        return sum(bp.cost for bp in self.blocks)


def bucket_boundaries(d_max: int, *, max_buckets: int = 8) -> tuple[int, ...]:
    """Power-of-two ELL bucket widths up to d_max, capped at max_buckets
    (dropping from the narrow end: low-degree rows then land in the
    smallest remaining boundary)."""
    bounds = []
    d = 1
    while d < max(d_max, 1):
        bounds.append(d)
        d *= 2
    bounds.append(max(d_max, 1))
    return tuple(bounds[-max_buckets:])


def measure_blocks(stripes: list[BlockEdges], b: int, *, stripe_axis: str) -> list[dict]:
    """Per-block measured stats from per-worker stripes (host numpy): b*b
    dicts, row-major (i, j), with nnz, rows, d_max and the per-row degrees.
    stripe_axis='gat': stripes[j] inner block k is M^(k, j); 'seg':
    stripes[i] inner block k is M^(i, k)."""
    assert stripe_axis in ("gat", "seg")
    out = [None] * (b * b)
    for worker, stripe in enumerate(stripes):
        counts = np.asarray(stripe.count)
        for k in range(b):
            i, j = (k, worker) if stripe_axis == "gat" else (worker, k)
            cnt = int(counts[k])
            if cnt:
                deg = np.bincount(np.asarray(stripe.seg_local[k, :cnt]))
                deg = deg[deg > 0]
                rec = {"nnz": cnt, "rows": int(deg.size),
                       "d_max": int(deg.max()), "deg": deg}
            else:
                rec = {"nnz": 0, "rows": 0, "d_max": 0,
                       "deg": np.zeros(0, np.int64)}
            out[i * b + j] = rec
    return out


def _merged_d_max(stripe: BlockEdges) -> int:
    """Max per-row in-degree of a horizontal stripe with all source blocks
    merged -- what the merged ELL layout buckets by."""
    counts = np.asarray(stripe.count)
    segs = [np.asarray(stripe.seg_local[k, : int(counts[k])])
            for k in range(stripe.seg_local.shape[0]) if int(counts[k])]
    if not segs:
        return 1
    deg = np.bincount(np.concatenate(segs))
    return max(int(deg.max()), 1)


def _classify(rec: dict, i: int, j: int, n_local: int,
              boundaries: tuple[int, ...], advantage: float) -> BlockPlan:
    if rec["nnz"] == 0:
        return BlockPlan(i=i, j=j, tactic="skip", nnz=0, rows=0, d_max=0,
                         occupancy=0.0, cost=0.0)
    bounds = np.asarray(boundaries, dtype=np.int64)
    bucket_of = np.searchsorted(bounds, rec["deg"], side="left")
    rows_per_bucket = np.bincount(bucket_of, minlength=len(boundaries))
    ell_cost = cost_model.ell_block_cost(int((rows_per_bucket * bounds).sum()))
    dense_cost = cost_model.dense_block_cost(n_local, advantage)
    tactic = "dense" if dense_cost < ell_cost else "ell"
    occ = rec["nnz"] / float(rec["rows"] * rec["d_max"])
    bucket_rows = tuple(rows_per_bucket.tolist()) if tactic == "ell" else ()
    return BlockPlan(i=i, j=j, tactic=tactic, nnz=rec["nnz"], rows=rec["rows"],
                     d_max=rec["d_max"], occupancy=round(occ, 4),
                     cost=min(ell_cost, dense_cost), bucket_rows=bucket_rows)


def plan_execution(
    pm,
    hm,
    *,
    strategy: str,
    mode: str,
    theta: float | None = None,
    capacity: int | None = None,
    scatter: str = "auto",
    stream: str = "off",
    max_buckets: int = 8,
    advantage: float = cost_model.DENSE_SLOT_ADVANTAGE,
    interpret: bool = False,
) -> ExecutionPlan:
    """Measure + classify every sub-block of the strategy's stripes.

    pm / hm: PartitionedMatrix / HybridMatrix | None from partition_graph.
    For 'hybrid' the table covers the sparse-region blocks (the dense region
    is a region-level dense tactic by construction, paper §3.5).
    ``scatter='auto'`` resolves here via the cost model's crossover;
    ``interpret`` marks a host whose kernel wrappers run the plain versions.
    """
    assert mode in MODES, mode
    assert stream in STREAM_MODES, stream
    if strategy == "hybrid":
        assert hm is not None
        stripes, axis = hm.sparse_vertical, "gat"
    elif strategy == "vertical":
        stripes, axis = pm.vertical, "gat"
    else:
        stripes, axis = pm.horizontal, "seg"
    b = pm.part.b
    n_local = pm.part.n_local

    recs = measure_blocks(stripes, b, stripe_axis=axis)
    if strategy == "horizontal":
        # merged layout: a destination row's ELL slots merge ALL its source
        # blocks, so buckets size to the full per-row in-degree.
        d_max = max((_merged_d_max(s) for s in stripes), default=1)
    else:
        d_max = max((r["d_max"] for r in recs), default=1)
    boundaries = bucket_boundaries(d_max, max_buckets=max_buckets)
    blocks = tuple(
        _classify(recs[i * b + j], i, j, n_local, boundaries, advantage)
        for i in range(b) for j in range(b))

    if scatter == "auto":
        t = b * capacity if capacity is not None else 0
        scatter = ("kernel" if (mode == "planned" and capacity is not None and
                                cost_model.prefer_kernel_scatter(
                                    t, n_local + 1, interpret=interpret))
                   else "segment")
    return ExecutionPlan(
        strategy=strategy, mode=mode, b=b, n_local=n_local, theta=theta,
        capacity=capacity, boundaries=boundaries, blocks=blocks,
        scatter=scatter, stream=stream)


def format_plan(plan: ExecutionPlan, *, extra: dict | None = None) -> str:
    """Human-readable plan report."""
    lines = [
        f"ExecutionPlan: strategy={plan.strategy} mode={plan.mode}"
        + (f" theta={plan.theta}" if plan.theta is not None else "")
        + (f" capacity={plan.capacity}" if plan.capacity is not None else "")
        + f" scatter={plan.scatter} stream={plan.stream}",
        f"  b={plan.b} n_local={plan.n_local} ell_buckets={plan.boundaries}",
    ]
    for k, v in (extra or {}).items():
        lines.append(f"  {k}={v}")
    counts = plan.tactic_counts()
    lines.append("  tactics: " + " ".join(f"{t}={counts[t]}" for t in TACTICS))
    flat, planned = plan.flat_padded_slots, plan.planned_slots
    if flat:
        lines.append(
            f"  ELL padded slots: flat {flat} -> planned {planned:.0f}"
            f" ({flat / max(planned, 1.0):.2f}x fewer)")
    lines.append(f"  {'block':>8}  {'tactic':<6} {'nnz':>8} {'rows':>6} {'d_max':>6} {'occ':>6} {'cost':>10}")
    for bp in plan.blocks:
        lines.append(
            f"  ({bp.i:>2},{bp.j:>2})  {bp.tactic:<6} {bp.nnz:>8} {bp.rows:>6}"
            f" {bp.d_max:>6} {bp.occupancy:>6.3f} {bp.cost:>10.0f}")
    return "\n".join(lines)
