"""PMVServer on PyTorch: pre-partition once, answer many concurrent GIM-V queries.

The paper amortizes pre-partitioning across the *iterations* of one solve
(§3.1); serving amortizes it across *queries*.  The resident matrix stays on
the device while query vectors come and go as columns of a blocked
[b, n_local, Q] batch: every placement (core/placement.py) carries the
trailing query axis, and with backend='auto' the planned executors run the
Q-wide kernels (``ell_gimv_multi``, ``dense_gimv_multi``,
``scatter_combine_gimv_multi``, or ``packed_scatter_combine_gimv_multi`` under
``exchange='packed'``), so one iteration of the batched step
advances all in-flight queries at the cost of one matrix traversal.

Continuous batching: each query column tracks its own convergence delta; a
converged column is retired (result extracted, latency recorded) and a
waiting query of the same family is admitted into the freed column mid-loop
without disturbing the others -- the GIM-V semirings are columnwise
independent.  All of an iteration's admissions go in with one in-place
``index_copy_`` along the query axis of v and of each ctx tensor.  Batches
are padded to fixed Q buckets (batcher.py).

Degradation under pressure: per-query ``deadline_s`` budgets (anchored at
submit; an expired column retires with its partial iterate), ``max_queue``
admission control (overloaded submits are shed at once), and batch-level
failure containment (an I/O or integrity error that survives the retry
layer -- ``OSError``, ``ShardCorruptError``, ``FetchDeadlineError`` -- fails
THAT batch's queries with the error's text and the server keeps serving).
Every retirement carries a reason -- completed | deadline_exceeded | shed |
failed -- tallied in ``stats()['retirement_reasons']``.

Serving from a store: ``PMVServer(store=..., residency=...)`` builds each
family's engine over an ingested block store (``repro_torch.store``); n, b
and psi are the store's.  Under residency='device' / 'host' the families
run the resident batched step on the loaded matrix; under 'disk' the
family's disk executor walks its block schedule each batched iteration (the
trailing query axis rides through the per-block bodies) and only the
active-column freeze and the per-query deltas are applied here.

Overflow: under ``capacity='model'`` a batched iteration can overflow the
compact exchange.  The truncated iteration is discarded, the family is
rebuilt on the engine's overflow-free configuration
(``PMVEngine.fallback_overrides``) and the batch's in-flight queries are
requeued under their qids (``stats()``: ``overflow_fallbacks``,
``requeued``, ``fallback_events``; the ``serve.fallbacks`` counter).

Faults: ``faults=`` (a ``repro_torch.faults`` plan or injector) is
normalized once and shared by every family engine, so a plan's events fire
once server-wide; fetch faults the retry layer absorbs never reach a query.

Tracing: ``obs=`` (a recorder, shared with every family engine and through
them the store) records a ``serve.batch`` span per batch, a fenced
``serve.iteration`` span per batched step, the ``serve.*`` counters, the
occupancy gauge and the latency, queue-wait and iteration histograms.

Live telemetry: ``telemetry=`` (True, a ``repro_torch.obs.TelemetryConfig``
or a shared ``LiveTelemetry``) feeds rolling-window latency, queue-wait,
iteration and throughput instruments and the SLO burn-rate tracker from the
retirement points, and with ``config.serve`` exposes them over HTTP
(``/metrics``, ``/metrics.json``); ``stats()['slo']`` holds the SLO
snapshot and ``close()`` stops the exporter's thread.  It is host
bookkeeping only: a served answer is bitwise the same with it on or off.

SPMD: ``mesh=`` / ``axis_name=`` run each family's engine with one rank
per worker (``PMVEngine``'s module doc); from a store under
residency='disk' a rank serves the workers of its own shard view.  Every
rank builds the same server and submits the same queries in the same
order; each holds its workers' rows of the batch, the per-query deltas are
summed over the workers, and a query's deadline expires on every rank when
it expires on one, so every rank retires and admits the same columns and
returns the same answers.

This is the counterpart of the JAX package's ``repro.serving.server``.  The
knobs the engine refuses raise as they do there.  As in the JAX package,
the server carries no delta-iteration state: a packed exchange ships its
full payload stream.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import algorithms, collectives
from repro_torch.core.engine import PMVEngine, StepConfig, placement_call, resolve_device
from repro_torch.core.gimv import GimvSpec
from repro_torch.faults import FetchDeadlineError, as_injector
from repro_torch.obs.live import as_telemetry
from repro_torch.obs.recorder import as_recorder
from repro_torch.serving.batcher import (
    DEFAULT_BUCKETS,
    RETIREMENT_REASONS,
    Query,
    QueryBatcher,
    QueryResult,
)
from repro_torch.store.manifest import ShardCorruptError

__all__ = ["PMVServer", "QueryFamily", "FAMILIES", "make_batched_step", "per_query_delta"]


# ---------------------------------------------------------------------------
# Query families: algorithm kind -> spec + per-query column construction.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryFamily:
    """How to turn queries of one kind into columns of a batched solve.

    delta_kind: 'abs' (sum |dv|, the PR/RWR metric) or 'count' (changed
      entries -- SSSP/CC, whose +-inf distances make abs-deltas NaN).
    empty_column: neutral fill for padded / retired-and-unreplaced columns;
      frozen by the active mask, it still flows through the kernels.
    """

    kind: str
    delta_kind: str
    make_spec: Callable[[int, Query], GimvSpec]
    init_column: Callable[[int, Query], np.ndarray]
    ctx_columns: Callable[[int, Query], dict[str, np.ndarray]]
    empty_column: Callable[[int], np.ndarray]
    symmetrize: bool = False


def _onehot(n: int, i: int) -> np.ndarray:
    x = np.zeros(n, np.float32)
    x[i] = 1.0
    return x


FAMILIES: dict[str, QueryFamily] = {
    "pagerank": QueryFamily(
        kind="pagerank",
        delta_kind="abs",
        make_spec=lambda n, q: algorithms.pagerank(n, damping=q.c),
        init_column=lambda n, q: np.full(n, 1.0 / n, np.float32),
        ctx_columns=lambda n, q: {},
        empty_column=lambda n: np.zeros(n, np.float32),
    ),
    "rwr": QueryFamily(
        kind="rwr",
        delta_kind="abs",
        make_spec=lambda n, q: algorithms.random_walk_with_restart(n, source=q.source, c=q.c),
        init_column=lambda n, q: _onehot(n, q.source),
        ctx_columns=lambda n, q: algorithms.rwr_context(n, q.source),
        empty_column=lambda n: np.zeros(n, np.float32),
    ),
    "sssp": QueryFamily(
        kind="sssp",
        delta_kind="count",
        make_spec=lambda n, q: algorithms.sssp(source=q.source),
        init_column=lambda n, q: np.where(np.arange(n) == q.source, np.float32(0.0),
                                          np.float32(np.inf)),
        ctx_columns=lambda n, q: {},
        empty_column=lambda n: np.full(n, np.inf, np.float32),
    ),
    "cc": QueryFamily(
        kind="cc",
        delta_kind="count",
        make_spec=lambda n, q: algorithms.connected_components(),
        init_column=lambda n, q: np.arange(n, dtype=np.int32),
        ctx_columns=lambda n, q: {},
        empty_column=lambda n: np.arange(n, dtype=np.int32),
        symmetrize=True,
    ),
}


# ---------------------------------------------------------------------------
# Batched step: placement with a trailing query axis + per-query convergence.
# ---------------------------------------------------------------------------

def per_query_delta(v: torch.Tensor, v_new: torch.Tensor, *, delta_kind: str) -> torch.Tensor:
    """Per-column convergence contribution: [.., n_local, Q] -> [Q]."""
    dims = tuple(range(v_new.ndim - 1))
    if delta_kind == "count":
        return torch.sum((v_new != v).to(torch.float32), dim=dims)
    return torch.sum(torch.abs(v_new - v), dim=dims)


def make_batched_step(spec: GimvSpec, cfg: StepConfig, mesh=None, axis_name="workers", *,
                      delta_kind: str = "abs"):
    """Build step(matrix, v, ctx, mask, active) -> (v_new, deltas [Q], stats).

    v/ctx carry a trailing query axis ([b, n_local, Q] in emulation; under a
    ``mesh`` this rank's worker's [1, n_local, Q], with the matrix and mask
    of an engine built on the same mesh).  ``active`` [Q] (a bool tensor on
    v's device) freezes retired / padded columns: their v entries pass
    through unchanged, so a column can sit retired while the rest of the
    batch keeps iterating.  Under a mesh the deltas are summed over the
    workers, so every rank sees the whole batch's.
    """
    axis = None if mesh is None else collectives.worker_axis(mesh, axis_name)

    def step(matrix, v, ctx, mask, active):
        v_new, _r, stats = placement_call(spec, cfg, matrix, v, ctx, mask, axis=axis)
        v_new, deltas = _freeze(v, v_new, active, delta_kind)
        return v_new, collectives.psum(deltas, axis), stats

    return step


def _make_disk_batched_step(executor, *, delta_kind: str):
    """Batched step over an out-of-core store (residency='disk'): the disk
    executor walks its block schedule exactly as in the single-vector path
    (the trailing query axis rides through the per-block bodies and the
    compaction), and only the active-column freeze and the per-query deltas
    are applied here.  Under a mesh (the executor's worker ``axis``) the
    deltas are summed over the workers, as ``make_batched_step`` sums
    them."""

    def step(matrix, v, ctx, mask, active):
        del matrix   # the executor owns the shard access
        v_new, _r, stats = executor.iteration(v, ctx, mask)
        v_new, deltas = _freeze(v, v_new, active, delta_kind)
        return v_new, collectives.psum(deltas, executor.axis), stats

    return step


def _freeze(v, v_new, active, delta_kind: str):
    """(v_new with the inactive columns frozen, per-query deltas [Q]):
    ``active`` broadcasts over the trailing Q axis."""
    v_new = torch.where(active, v_new, v)
    return v_new, per_query_delta(v, v_new, delta_kind=delta_kind)


# ---------------------------------------------------------------------------
# The server.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _FamilyState:
    family: QueryFamily
    spec: GimvSpec
    engine: PMVEngine
    step: Callable
    matrix: dict
    mask: torch.Tensor
    part: object
    meta: dict
    blocked_ids: torch.Tensor   # [b_w * n_local] global id of each held slot, n for padding
    global_pos: torch.Tensor    # [n] blocked slot of each global id


# per-iteration stats summed into stats(); the store_* keys only a disk
# family reports (zero for a resident one)
_SUMMED = ("gathered_elems", "exchanged_elems", "logical_elems") + PMVEngine._IO_TOTAL_KEYS


class PMVServer:
    """Multi-query GIM-V serving over one resident pre-partitioned matrix.

    submit() enqueues queries; drain() packs them into Q-bucket batches per
    family, iterates the batched step with per-query convergence tracking,
    and continuously admits waiting queries into retired columns.  The
    partition, plan and device-resident matrix are built once per family
    (its engine's ``prepare``) and cached across batches and drain calls.

    device: None (the GPU; raises without one) | 'cuda' | 'cpu', as for
    :class:`PMVEngine`.  The other engine knobs (strategy, theta, psi,
    exchange, capacity, slack, payload_dtype, backend, scatter, stream,
    pallas_interpret, base_weights, mesh, axis_name, io_retry, obs, faults)
    are passed to each family's engine (backend='pallas' runs the flat-ELL
    tables through the Q-wide kernels),
    and with ``store=`` also
    ``residency`` and ``store_budget_bytes`` (without a store the server,
    like the JAX package's, holds its edges resident and ignores them).
    ``stats()['iter_wall_s']`` holds the host walls of the most recent
    batched iterations (each ends with the one device->host copy of the
    iteration's deltas); the ``store_*`` keys sum a disk family's I/O
    accounting over its batched iterations.
    """

    _ITER_WALLS_KEPT = 4096

    def __init__(
        self,
        edges: np.ndarray | None = None,
        n: int | None = None,
        *,
        b: int | None = None,
        strategy: str = "selective",
        theta: float | str = "auto",
        psi: str | None = None,
        exchange: str = "sparse",
        capacity: str = "structural",
        slack: float = 1.5,
        payload_dtype: str | None = None,
        backend: str = "torch",
        scatter: str = "auto",
        stream: str = "auto",
        pallas_interpret: bool | None = None,
        base_weights: np.ndarray | None = None,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        max_iters: int = 200,
        mesh=None,
        axis_name="workers",
        store=None,
        residency: str = "device",
        store_budget_bytes: int | None = None,
        obs=None,
        faults=None,
        io_retry=None,
        max_queue: int | None = None,
        telemetry=None,
        device=None,
    ):
        self.store = None
        self.residency = residency
        self.store_budget_bytes = store_budget_bytes
        if store is not None:
            # serving from an ingested block store (path or Manifest): n, b
            # and psi are the store's
            from repro_torch.store import open_store

            self.store = open_store(store)
            if edges is not None:
                raise ValueError("pass either edges or store=, not both")
            if n is not None and int(n) != self.store.n:
                raise ValueError(f"n={n} does not match the store's n={self.store.n}")
            if b is not None and int(b) != self.store.b:
                raise ValueError(f"b={b} does not match the store's b={self.store.b}")
            n, b = self.store.n, self.store.b
            self.edges = None
        else:
            if edges is None or n is None or b is None:
                raise ValueError("PMVServer needs (edges, n, b=) or store=")
            self.edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.mesh, self.axis_name = mesh, axis_name
        self.n = int(n)
        self.b = int(b)
        self.max_iters = int(max_iters)
        # obs is shared with every family engine (and through it the disk
        # executor and store), so one recorder traces the whole serving run
        self.obs = as_recorder(obs)
        self._engine_kwargs = dict(
            strategy=strategy, theta=theta, psi=psi, exchange=exchange,
            capacity=capacity, slack=slack, payload_dtype=payload_dtype, backend=backend,
            scatter=scatter, stream=stream, pallas_interpret=pallas_interpret,
            base_weights=base_weights,
            io_retry=io_retry, obs=self.obs, mesh=mesh, axis_name=axis_name,
            device=resolve_device(device),
            # normalized ONCE, so every family engine shares one injector and
            # a plan's events fire once server-wide, not once per family
            faults=as_injector(faults, self.obs))
        # the engine checks its own knobs: fail here, not at the first batch
        probe = self._engine(symmetrize=False)
        self.axis = probe.axis
        self.device = self._engine_kwargs["device"] = probe.device
        # admission control: queries submitted while >= max_queue are waiting
        # are shed immediately (reason='shed').  None = accept everything.
        self.max_queue = max_queue
        self._batcher = QueryBatcher(buckets)
        self._families: dict[tuple, _FamilyState] = {}
        self._family_overrides: dict[tuple, dict] = {}  # overflow fallbacks
        self._results: dict[int, QueryResult] = {}
        self._next_qid = 0
        self._fallback_events: list[str] = []  # fallback labels, batch order
        self._occupancy_sum = 0.0              # sum over batches of |queries|/Q
        self._retirement_reasons = {r: 0 for r in RETIREMENT_REASONS}
        self._iter_walls: collections.deque = collections.deque(maxlen=self._ITER_WALLS_KEPT)
        self._stats = {
            "batches": 0, "queries": 0, "admitted_mid_batch": 0,
            "overflow_fallbacks": 0, "retired": 0, "requeued": 0,
            "shed": 0, "failed_batches": 0,
            "queue_wait_s": 0.0,
            "iterations": 0.0, "wall_s": 0.0,
            **{k: 0.0 for k in _SUMMED},
        }
        # live telemetry: rolling-window latency/throughput + SLO burn rates
        # over the retirement stream, optionally served over HTTP; last, so
        # a refused knob above never leaves an exporter thread behind
        self.telemetry = as_telemetry(
            telemetry, registry=self.obs.metrics if self.obs.enabled else None)
        if self.telemetry is not None and self.telemetry.config.serve:
            self.telemetry.start_server()

    # ------------------------------------------------------------------
    def submit(self, query: Query) -> int:
        """Enqueue a query; returns its qid (key into drain()'s results).

        Load shedding: when ``max_queue`` is set and that many queries are
        already waiting, the query is refused up front -- drain() returns a
        ``reason='shed'`` result for its qid (vector None).
        """
        if not 0 <= query.source < self.n:
            raise ValueError(
                f"query source {query.source} out of range for |V|={self.n}")
        if query.qid is not None:  # resubmission: don't alias the old entry
            query = dataclasses.replace(query, qid=None, t_submit=None)
        qid = self._next_qid
        self._next_qid += 1
        query.qid = qid
        query.t_submit = time.perf_counter()
        self._stats["queries"] += 1
        if self.max_queue is not None and len(self._batcher) >= self.max_queue:
            self._retire_unserved(query, "shed")
            self._stats["shed"] += 1
            self.obs.counter("serve.shed").add(1)
            return qid
        self._batcher.add(query)
        if self.telemetry is not None:
            self.telemetry.record_queue_depth(len(self._batcher))
        return qid

    def _retire_unserved(self, query: Query, reason: str, error: str | None = None) -> None:
        """Record a result for a query whose column never (or no longer)
        iterates: shed at admission or lost to a failed batch."""
        latency = time.perf_counter() - query.t_submit
        self._results[query.qid] = QueryResult(
            qid=query.qid, query=query, vector=None, iterations=0, converged=False,
            latency_s=latency, reason=reason, error=error)
        self._retirement_reasons[reason] += 1
        if self.telemetry is not None:
            self.telemetry.record_retirement(
                reason, latency, had_deadline=query.deadline_s is not None)

    def drain(self) -> dict[int, QueryResult]:
        """Serve every queued query to convergence; returns {qid: result}."""
        while True:
            nxt = self._batcher.next_batch()
            if nxt is None:
                break
            key, batch = nxt
            self._run_batch(key, batch)
        out, self._results = self._results, {}
        return out

    def serve(self, queries: list[Query]) -> list[QueryResult]:
        """submit() + drain(), results in submission order."""
        qids = [self.submit(q) for q in queries]
        results = self.drain()
        return [results[qid] for qid in qids]

    def stats(self) -> dict:
        """Serving counters: batches/queries/iterations plus the retirement
        ledger -- ``retired`` answered columns, ``requeued`` queries sent back
        through the batcher by an overflow fallback, ``fallback_events`` (the
        fallback labels, batch order), total ``queue_wait_s``, mean
        ``batch_occupancy`` (real queries / bucket capacity) and the recent
        batched-iteration walls ``iter_wall_s``."""
        out = dict(self._stats)
        out["fallback_events"] = list(self._fallback_events)
        out["retirement_reasons"] = dict(self._retirement_reasons)
        out["batch_occupancy"] = (
            self._occupancy_sum / out["batches"] if out["batches"] else 0.0)
        out["iter_wall_s"] = list(self._iter_walls)
        io_s, wait_s = out["store_io_s"], out["store_wait_s"]
        out["store_overlap"] = max(0.0, 1.0 - wait_s / io_s) if io_s > 0.0 else 1.0
        if self.telemetry is not None:
            out["slo"] = self.telemetry.slo.snapshot()
        return out

    def engine_for(self, query: Query) -> tuple[PMVEngine, GimvSpec]:
        """The engine and spec of ``query``'s family (prepared on first use).

        A hook for parity checks, not serving API (the JAX server has no
        such method): ``engine.prepare(spec)`` returns the resident matrix
        the batches run on, and ``engine.run(spec, ctx, v0=...)`` answers one
        query alone on it through the single-vector path."""
        st = self._family_state(query.family_key, query)
        return st.engine, st.spec

    def close(self) -> None:
        """Drop the cached family states, and with them their device-resident
        matrices and their disk executors' prefetch threads, and stop the
        telemetry HTTP exporter's thread, if one was started."""
        for key in list(self._families):
            self._drop_family(key)
        if self.telemetry is not None:
            self.telemetry.close()

    def _drop_family(self, key: tuple) -> None:
        st = self._families.pop(key, None)
        if st is not None and st.meta.get("executor") is not None:
            st.meta["executor"].close()

    # ------------------------------------------------------------------
    def _engine(self, symmetrize: bool, overrides: dict | None = None) -> PMVEngine:
        """A family's engine: over the store (with its residency and budget)
        when the server has one, else over the edge list; ``overrides`` are
        the family's overflow fallbacks."""
        kwargs = {**self._engine_kwargs, **(overrides or {})}
        if self.store is not None:
            return PMVEngine(None, store=self.store, residency=self.residency,
                             store_budget_bytes=self.store_budget_bytes,
                             symmetrize=symmetrize, **kwargs)
        return PMVEngine(self.edges, self.n, b=self.b, symmetrize=symmetrize, **kwargs)

    def _family_state(self, key: tuple, sample: Query) -> _FamilyState:
        if key not in self._families:
            family = FAMILIES[sample.spec_kind]
            spec = family.make_spec(self.n, sample)
            if self.store is not None and family.symmetrize and not self.store.symmetrized:
                raise ValueError(
                    f"query family {family.kind!r} needs a symmetrized graph but the "
                    "store was ingested without symmetrize — re-ingest with "
                    "ingest_edges(symmetrize=True)")
            engine = self._engine(family.symmetrize, self._family_overrides.get(key))
            matrix, _v0, _ctx, mask, meta = engine.prepare(spec)
            if meta["residency"] == "disk":
                step = _make_disk_batched_step(meta["executor"], delta_kind=family.delta_kind)
            else:
                step = make_batched_step(spec, meta["cfg"], self.mesh, self.axis_name,
                                         delta_kind=family.delta_kind)
                step = engine.on_device(step)
            part = meta["part"]
            ids = np.minimum(engine.own_rows(part.global_ids_grid()).reshape(-1), self.n)
            g = np.arange(self.n)
            pos = part.block_of(g) * part.n_local + part.local_of(g)
            self._families[key] = _FamilyState(
                family=family, spec=spec, engine=engine, step=step, matrix=matrix,
                mask=mask, part=part, meta=meta,
                blocked_ids=torch.from_numpy(ids).to(self.device),
                global_pos=torch.from_numpy(pos).to(self.device))
        return self._families[key]

    def _column(self, st: _FamilyState, query: Query | None):
        """(v column [n], ctx columns) of a query (None -> neutral pad)."""
        fam = st.family
        if query is None:
            return fam.empty_column(self.n), {
                k: np.zeros_like(x)
                for k, x in fam.ctx_columns(self.n, Query(spec_kind=fam.kind)).items()}
        return fam.init_column(self.n, query), fam.ctx_columns(self.n, query)

    def _blocked(self, st: _FamilyState, cols: list[np.ndarray]) -> torch.Tensor:
        """Global columns [n] -> the held rows of the blocked batch
        [b_w, n_local, k] on the device (all b in emulation, this rank's
        worker's one under a mesh).  The columns go over stacked whole and
        one gather on the device blocks them (padding slots get 0, as
        Partition.to_blocked gives them): a host write of each column into
        [b, n_local, Q] would touch a new cache line per element."""
        x = torch.from_numpy(np.stack(cols)).to(self.device)               # [k, n]
        x = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)            # column n: 0
        return x[:, st.blocked_ids].T.reshape(-1, st.part.n_local, len(cols)).contiguous()

    def _global(self, st: _FamilyState, v: torch.Tensor, slots: list[int]) -> np.ndarray:
        """Columns ``slots`` of the blocked batch -> [len(slots), n] on the
        host (gathered from every worker under a mesh)."""
        cols = v.index_select(2, torch.tensor(slots, device=self.device))  # [b_w, n_local, r]
        cols = collectives.all_gather(cols, self.axis)                      # [b, n_local, r]
        flat = cols.reshape(-1, len(slots)).index_select(0, st.global_pos)  # [n, r]
        return flat.T.contiguous().cpu().numpy()

    def _run_batch(self, key: tuple, batch: list[Query]) -> None:
        obs = self.obs
        with obs.span("serve.batch") as batch_span:
            batch_span.set("family", str(key))
            try:
                self._run_batch_inner(key, batch, batch_span)
            except (ShardCorruptError, OSError, FetchDeadlineError) as e:
                # The I/O / integrity layer exhausted its retries: the batch
                # is lost, but the SERVER is not -- every unanswered query in
                # it retires with reason='failed' and the error's text, and
                # later batches (other families, a restored store) proceed.
                self._stats["failed_batches"] += 1
                obs.counter("serve.failed_batches").add(1)
                batch_span.set("failed", type(e).__name__)
                self._drop_family(key)  # state may be half-built
                for query in batch:
                    if query.qid not in self._results:
                        self._retire_unserved(query, "failed", error=str(e))

    def _run_batch_inner(self, key: tuple, batch: list[Query], batch_span) -> None:
        obs = self.obs
        st = self._family_state(key, batch[0])
        dev = self.device
        n_q = self._batcher.bucket_for(len(batch))
        self._stats["batches"] += 1
        self._occupancy_sum += len(batch) / n_q
        obs.gauge("serve.batch_occupancy").set(len(batch) / n_q)
        batch_span.set("n_q", n_q)
        batch_span.set("queries", len(batch))

        slots: list[Query | None] = [batch[q_i] if q_i < len(batch) else None
                                     for q_i in range(n_q)]
        columns = [self._column(st, query) for query in slots]
        v = self._blocked(st, [c[0] for c in columns])
        ctx = {k: self._blocked(st, [c[1][k] for c in columns]) for k in columns[0][1]}
        del columns
        active = np.array([s is not None for s in slots])
        iters = np.zeros(n_q, np.int64)
        tols = np.array([s.tol if s else 0.0 for s in slots])
        caps = np.array([(s.max_iters or self.max_iters) if s else 0 for s in slots])
        # absolute per-query deadlines (inf = none), anchored at SUBMIT time:
        # queue wait counts against the budget, as a caller's SLO would.
        dls = np.array([(s.t_submit + s.deadline_s)
                        if s is not None and s.deadline_s is not None
                        else np.inf for s in slots])
        # queue wait ends when a query's column starts iterating: now for the
        # initial slots, the admission instant for mid-batch admissions.
        starts = np.full(n_q, time.perf_counter())

        while active.any():
            t0 = time.perf_counter()
            with obs.span("serve.iteration") as sp:
                active_t = torch.from_numpy(active).to(dev)
                v_new, deltas, stats = st.step(st.matrix, v, ctx, st.mask, active_t)
                keys = [k for k, x in stats.items() if isinstance(x, torch.Tensor)]
                flat = torch.cat([deltas.to(torch.float32)]
                                 + [stats[k].to(torch.float32).reshape(1) for k in keys])
                # fenced once the copies' launches are queued (see PMVEngine.run)
                v_new = obs.fence(v_new)
                # one device->host copy per iteration for the per-query deltas
                # and every scalar the iteration produced (it also waits for
                # the step)
                host = flat.tolist()
                sp.set("active", int(active.sum()))
            deltas_h = np.asarray(host[:n_q])
            # (an SPMD disk family's store_worker_* lists are left out)
            scalars = {k: float(x) for k, x in stats.items()
                       if not isinstance(x, (torch.Tensor, list))}
            scalars.update(zip(keys, host[n_q:]))
            iter_wall = time.perf_counter() - t0
            self._iter_walls.append(iter_wall)
            self._stats["wall_s"] += iter_wall
            self._stats["iterations"] += 1
            if self.telemetry is not None:
                self.telemetry.record_iteration(iter_wall, active=int(active.sum()))
                self.telemetry.record_queue_depth(len(self._batcher))
            for k in _SUMMED:
                self._stats[k] += scalars.get(k, 0.0)
            if scalars.get("overflow", 0.0) > 0:
                # A truncated exchange would silently corrupt EVERY in-flight
                # column (the shared index set unions rows across queries),
                # so the truncated iteration is discarded.  Where an
                # overflow-free configuration exists (the engine's fallback
                # table), the family is rebuilt with it and the batch's
                # in-flight queries are requeued: they restart, under their
                # qids.  The default capacity='structural' cannot overflow.
                fb = st.engine.fallback_overrides(st.meta["strategy"])
                if fb is None:
                    lost = sorted(q.qid for q in slots if q is not None)
                    raise RuntimeError(
                        "sparse exchange overflow in batched serving: capacity "
                        f"{st.meta['capacity']} too small for the query batch -- "
                        "construct the server with capacity='structural' or "
                        f"exchange='dense'; unanswered qids in this batch: {lost}")
                label, overrides = fb
                self._stats["overflow_fallbacks"] += 1
                self._fallback_events.append(label)
                obs.counter("serve.fallbacks").add(1)
                batch_span.set("fallback", label)
                self._family_overrides[key] = {**self._family_overrides.get(key, {}),
                                               **overrides}
                self._drop_family(key)  # rebuilt with the fallback on requeue
                for query in slots:
                    if query is not None:
                        self._batcher.add(query)  # keeps its qid
                        self._stats["requeued"] += 1
                return
            iters[active] += 1

            # columns that retire this iteration: converged, capped or expired
            now = time.perf_counter()
            expired_q = now > dls
            if self.axis is not None and np.isfinite(dls).any():
                # the ranks' clocks differ: a deadline expires on every rank
                # when it expires on one, so all retire the same columns
                flags = torch.from_numpy(expired_q.astype(np.int64)).to(dev)
                expired_q = collectives.psum(flags, self.axis).cpu().numpy() > 0
            retiring = []
            for q_i in np.nonzero(active)[0]:
                done = bool(deltas_h[q_i] < tols[q_i])
                expired = not done and bool(expired_q[q_i])
                if done or expired or iters[q_i] >= caps[q_i]:
                    retiring.append((int(q_i), done, expired))
            if not retiring:
                v = v_new
                continue
            answers = self._global(st, v_new, [r[0] for r in retiring])

            admissions: list[tuple[int, np.ndarray, dict]] = []
            for j, (q_i, done, expired) in enumerate(retiring):
                # An expired query still gets its PARTIAL iterate back -- the
                # caller asked for the best answer by the deadline.
                query = slots[q_i]
                reason = "deadline_exceeded" if expired else "completed"
                latency = time.perf_counter() - query.t_submit
                self._results[query.qid] = QueryResult(
                    qid=query.qid, query=query, vector=answers[j],
                    iterations=int(iters[q_i]), converged=done,
                    latency_s=latency, reason=reason)
                self._retirement_reasons[reason] += 1
                if expired:
                    obs.counter("serve.deadline_exceeded").add(1)
                self._stats["retired"] += 1
                wait = max(0.0, starts[q_i] - query.t_submit)
                self._stats["queue_wait_s"] += wait
                if self.telemetry is not None:
                    self.telemetry.record_retirement(
                        reason, latency, queue_wait_s=wait,
                        had_deadline=query.deadline_s is not None)
                if obs.enabled:
                    obs.counter("serve.retired").add(1)
                    obs.histogram("serve.query_latency_s").observe(latency)
                    obs.histogram("serve.queue_wait_s").observe(wait)
                    obs.histogram("serve.query_iterations").observe(int(iters[q_i]))
                # admit a waiting query of the same family into the freed slot
                waiting = self._batcher.pop_waiting(key)
                if waiting is not None:
                    self._stats["admitted_mid_batch"] += 1
                    batch.append(waiting)  # a later batch failure must see it
                    slots[q_i] = waiting
                    v_col, ctx_cols = self._column(st, waiting)
                    admissions.append((q_i, v_col, ctx_cols))
                    iters[q_i] = 0
                    tols[q_i] = waiting.tol
                    caps[q_i] = waiting.max_iters or self.max_iters
                    dls[q_i] = (waiting.t_submit + waiting.deadline_s
                                if waiting.deadline_s is not None else np.inf)
                    starts[q_i] = time.perf_counter()
                else:
                    slots[q_i] = None
                    active[q_i] = False
            if admissions:
                # one in-place index_copy_ along the query axis admits the
                # whole iteration's queries into v and each ctx tensor
                slot_idx = torch.tensor([a[0] for a in admissions], device=dev)
                v_new.index_copy_(2, slot_idx, self._blocked(st, [a[1] for a in admissions]))
                for k in ctx:
                    ctx[k].index_copy_(2, slot_idx,
                                       self._blocked(st, [a[2][k] for a in admissions]))
            v = v_new
