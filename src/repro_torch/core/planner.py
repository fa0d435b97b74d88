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
schedule (``stream``: 'on' runs the bucket-streamed executor, one
destination block at a time, see :meth:`ExecutionPlan.memory_profile`) and
where the matrix lives (``residency``).  Tactic tables equal the JAX
package's for the same graph and knobs, whether measured from in-memory stripes
(:func:`plan_execution`) or rebuilt from a store manifest's persisted
measurements (:func:`plan_from_stats`).
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
    "plan_from_stats",
    "deg_hist_of",
    "DEG_HIST_BINS",
    "format_plan",
    "TACTICS",
    "MODES",
    "STREAM_MODES",
    "RESIDENCY_MODES",
]

TACTICS = ("skip", "ell", "dense")
MODES = ("torch", "pallas", "planned")
STREAM_MODES = ("on", "off")
RESIDENCY_MODES = cost_model.RESIDENCY_MODES


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
    backend and 'pallas' the forced flat-ELL one (their executors ignore
    the tactic table, which explain() still reports; the out-of-core
    executor plans in 'torch', as the JAX package's plans in 'xla')."""

    strategy: str                   # 'horizontal' | 'vertical' | 'hybrid'
    mode: str                       # 'torch' | 'pallas' | 'planned'
    b: int
    n_local: int
    theta: float | None
    capacity: int | None
    boundaries: tuple[int, ...]     # bucket width boundaries (ascending)
    blocks: tuple[BlockPlan, ...]   # b*b entries, row-major (i, j)
    scatter: str = "segment"        # receive-side tactic: 'segment' | 'kernel'
    stream: str = "off"             # partial schedule
    residency: str = "device"       # matrix home: 'device' | 'host' | 'disk'
    e_cap: int | None = None        # padded edge capacity of the shard slices

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.residency in RESIDENCY_MODES, self.residency
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

    def launch_schedule(self, worker: int) -> tuple[tuple, ...]:
        """Per-DESTINATION-block launch schedule of one worker's vertical
        stripe.  Entry i describes destination block M^(i, worker):
        ('skip',) | ('dense', n_local) | ('ell', rows_per_bucket), where
        rows_per_bucket[k] is the number of destination rows bucket k's
        [R_k, boundaries[k]] table holds for this block."""
        sched = []
        for i in range(self.b):
            bp = self.block(i, worker)
            if bp.tactic == "skip":
                sched.append(("skip",))
            elif bp.tactic == "dense":
                sched.append(("dense", self.n_local))
            else:
                sched.append(("ell", bp.bucket_rows))
        return tuple(sched)

    def block_attrs(self, i: int, j: int) -> dict:
        """Static launch-span attributes of one sub-block: tactic, measured
        shape, and the cost model's prediction -- what the obs profiler
        attaches to each ``launch.ell`` / ``launch.dense`` span so the
        predicted-vs-measured report can join without replanning.
        ``predicted_s`` is ``predicted_cost`` at ``cost_model.SLOT_TIME_S``
        (a data-sheet anchor for the H100, not a measurement)."""
        bp = self.block(i, j)
        return {
            "i": i, "j": j, "tactic": bp.tactic, "nnz": bp.nnz,
            "rows": bp.rows, "d_max": bp.d_max, "occupancy": bp.occupancy,
            "predicted_cost": bp.cost,
            "predicted_s": cost_model.slot_seconds(bp.cost),
        }

    def launch_cost(self, k: int, *, axis: str = "dest") -> float:
        """Predicted slot cost of one launch-schedule step: destination
        block k across every worker stripe (axis='dest', the vertical
        schedule) or source block k (axis='src', horizontal)."""
        if axis == "dest":
            return sum(self.block(k, j).cost for j in range(self.b))
        return sum(self.block(i, k).cost for i in range(self.b))

    def launch_attrs(self, k: int, *, axis: str = "dest") -> dict:
        """Static span attributes of one schedule step: its predicted slot
        cost (see :meth:`launch_cost`) and ``predicted_s``, that cost in
        seconds at ``cost_model.SLOT_TIME_S`` (a data-sheet anchor for the
        H100, not a measurement)."""
        cost = self.launch_cost(k, axis=axis)
        return {"block": k, "axis": axis, "predicted_cost": cost,
                "predicted_s": cost_model.slot_seconds(cost)}

    def memory_profile(self) -> dict:
        """Estimated live partial-buffer elements per worker of the
        vertical/hybrid step: 'materialized' holds all b destination-block
        partials before compaction (O(b * n_local)); 'streamed' holds one
        partial in flight plus the fixed compact exchange buffer
        (O(n_local + b * cap), the paper Alg. 2's profile).  'savings' is
        their ratio; 'stream' echoes the plan's resolved schedule."""
        cap = self.capacity if self.capacity is not None else self.n_local
        mat = cost_model.materialized_partial_elems(self.b, self.n_local)
        strm = cost_model.streamed_partial_elems(self.b, self.n_local, cap)
        return {"materialized_elems": mat, "streamed_elems": strm,
                "savings": mat / max(strm, 1), "stream": self.stream}

    def io_bytes_per_iter(self, *, has_w: bool = False) -> int:
        """Modeled shard bytes READ per iteration under residency='disk':
        one [b, e_cap] seg+gat slice (plus the counts) per scheduled
        (non-empty) destination block (vertical) or source block
        (horizontal); 0 when resident.  Equals the disk executor's measured
        ``store_bytes_read``: weights are recomputed, never read."""
        if self.residency != "disk" or self.e_cap is None:
            return 0
        active = {bp.i if self.strategy != "horizontal" else bp.j
                  for bp in self.blocks if bp.nnz}
        return len(active) * cost_model.stripe_slice_bytes(self.b, self.e_cap, has_w=has_w)

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


DEG_HIST_BINS = 64  # power-of-two degree histogram width (degrees < 2^63)


def deg_hist_of(deg: np.ndarray) -> np.ndarray:
    """Per-block power-of-two degree histogram: hist[k] = destination rows
    with in-degree in (2^(k-1), 2^k] (k=0: degree exactly 1; the last bin
    catches everything above 2^62).  The store manifest persists these so
    plans rebuilt from a manifest classify blocks exactly as plans measured
    from in-memory stripes."""
    edges = 1 << np.arange(DEG_HIST_BINS - 1, dtype=np.int64)
    bins = np.searchsorted(edges, np.asarray(deg, dtype=np.int64), side="left")
    return np.bincount(bins, minlength=DEG_HIST_BINS)


def _bucket_rows_of(rec: dict, boundaries: tuple[int, ...]) -> np.ndarray:
    """Rows per ELL degree bucket, from either the measured per-row degrees
    ('deg') or the manifest's power-of-two histogram ('deg_hist').  The two
    agree: the boundaries are powers of two plus the final d_max, so no
    boundary falls strictly inside a histogram bin below d_max."""
    bounds = np.asarray(boundaries, dtype=np.int64)
    if "deg" in rec:
        bucket_of = np.searchsorted(bounds, rec["deg"], side="left")
        return np.bincount(bucket_of, minlength=len(boundaries))
    hist = np.asarray(rec["deg_hist"], dtype=np.int64)
    out = np.zeros(len(boundaries), dtype=np.int64)
    for k in np.nonzero(hist)[0]:
        rep = min(1 << int(k), int(bounds[-1]))  # the bin's top degree, capped
        out[int(np.searchsorted(bounds, rep, side="left"))] += int(hist[k])
    return out


def _classify(rec: dict, i: int, j: int, n_local: int,
              boundaries: tuple[int, ...], advantage: float,
              io_cost: float = 0.0) -> BlockPlan:
    if rec["nnz"] == 0:
        return BlockPlan(i=i, j=j, tactic="skip", nnz=0, rows=0, d_max=0,
                         occupancy=0.0, cost=0.0)
    bounds = np.asarray(boundaries, dtype=np.int64)
    rows_per_bucket = _bucket_rows_of(rec, boundaries)
    ell_cost = cost_model.ell_block_cost(int((rows_per_bucket * bounds).sum()))
    dense_cost = cost_model.dense_block_cost(n_local, advantage)
    tactic = "dense" if dense_cost < ell_cost else "ell"
    occ = rec["nnz"] / float(rec["rows"] * rec["d_max"])
    bucket_rows = tuple(rows_per_bucket.tolist()) if tactic == "ell" else ()
    return BlockPlan(i=i, j=j, tactic=tactic, nnz=rec["nnz"], rows=rec["rows"],
                     d_max=rec["d_max"], occupancy=round(occ, 4),
                     cost=min(ell_cost, dense_cost) + io_cost, bucket_rows=bucket_rows)


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
    residency: str = "device",
) -> ExecutionPlan:
    """Measure + classify every sub-block of the strategy's stripes.

    pm / hm: PartitionedMatrix / HybridMatrix | None from partition_graph.
    For 'hybrid' the table covers the sparse-region blocks (the dense region
    is a region-level dense tactic by construction, paper §3.5).
    ``scatter='auto'`` resolves here via the cost model's crossover;
    ``interpret`` marks a host whose kernel wrappers run the plain versions.
    """
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
    merged_d_max = None
    if strategy == "horizontal":
        merged_d_max = max((_merged_d_max(s) for s in stripes), default=1)
    return plan_from_stats(
        recs, b=b, n_local=n_local, strategy=strategy, mode=mode, theta=theta,
        capacity=capacity, scatter=scatter, stream=stream, max_buckets=max_buckets,
        advantage=advantage, interpret=interpret, residency=residency,
        merged_d_max=merged_d_max)


def plan_from_stats(
    recs: list[dict],
    *,
    b: int,
    n_local: int,
    strategy: str,
    mode: str,
    theta: float | None = None,
    capacity: int | None = None,
    scatter: str = "auto",
    stream: str = "off",
    max_buckets: int = 8,
    advantage: float = cost_model.DENSE_SLOT_ADVANTAGE,
    interpret: bool = False,
    residency: str = "device",
    merged_d_max: int | None = None,
) -> ExecutionPlan:
    """ExecutionPlan from per-block measurement records: the b*b row-major
    list of :func:`measure_blocks`, or its persisted form rebuilt from a
    store manifest, where each record carries the power-of-two degree
    histogram ('deg_hist') in place of the per-row degrees; both classify
    alike (``_bucket_rows_of``).  ``merged_d_max`` sizes the buckets of the
    horizontal merged layout (the full per-row in-degree).
    ``residency='disk'`` adds the shard-streaming I/O term
    (``cost_model.disk_block_io_cost``) to every non-skip block's cost.
    """
    assert mode in MODES, mode
    assert stream in STREAM_MODES, stream
    assert residency in RESIDENCY_MODES, residency
    if strategy == "horizontal" and merged_d_max is not None:
        # merged layout: a destination row's ELL slots merge ALL its source
        # blocks, so buckets size to the full per-row in-degree.
        d_max = merged_d_max
    else:
        d_max = max((r["d_max"] for r in recs), default=1)
    boundaries = bucket_boundaries(d_max, max_buckets=max_buckets)
    e_cap = max(max((r["nnz"] for r in recs), default=1), 1)
    io_cost = cost_model.disk_block_io_cost(e_cap) if residency == "disk" else 0.0
    blocks = tuple(
        _classify(recs[i * b + j], i, j, n_local, boundaries, advantage, io_cost=io_cost)
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
        scatter=scatter, stream=stream, residency=residency, e_cap=e_cap)


def format_plan(plan: ExecutionPlan, *, extra: dict | None = None) -> str:
    """Human-readable plan report."""
    lines = [
        f"ExecutionPlan: strategy={plan.strategy} mode={plan.mode}"
        + (f" theta={plan.theta}" if plan.theta is not None else "")
        + (f" capacity={plan.capacity}" if plan.capacity is not None else "")
        + f" scatter={plan.scatter} stream={plan.stream}"
        + (f" residency={plan.residency}" if plan.residency != "device" else ""),
        f"  b={plan.b} n_local={plan.n_local} ell_buckets={plan.boundaries}",
    ]
    if plan.residency == "disk":
        io = plan.io_bytes_per_iter()
        lines.append(f"  disk I/O: ~{io} shard bytes/iter (e_cap={plan.e_cap},"
                     f" ~{cost_model.disk_io_seconds(io) * 1e3:.2f} ms modeled)")
    for k, v in (extra or {}).items():
        lines.append(f"  {k}={v}")
    counts = plan.tactic_counts()
    lines.append("  tactics: " + " ".join(f"{t}={counts[t]}" for t in TACTICS))
    if plan.capacity is not None and plan.strategy != "horizontal":
        # only the vertical/hybrid compact path materializes partials
        mp = plan.memory_profile()
        lines.append(
            f"  memory profile: materialized {mp['materialized_elems']} elems"
            f" -> streamed {mp['streamed_elems']} elems"
            f" ({mp['savings']:.2f}x) [stream={mp['stream']}]")
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
