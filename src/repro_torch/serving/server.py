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
failure containment (an ``OSError`` fails THAT batch's queries with the
error's text and the server keeps serving).  Every retirement carries a
reason -- completed | deadline_exceeded | shed | failed -- tallied in
``stats()['retirement_reasons']``.

This is the counterpart of the JAX package's ``repro.serving.server``.  Its
knobs outside the ported slice (``store``, ``residency`` other than
'device', ``mesh``, ``obs``, ``faults``, ``io_retry``, ``telemetry``,
``exchange='hier'``, and what the engine itself refuses) raise
NotImplementedError.  As in the JAX package, the server carries no
delta-iteration state: a packed exchange ships its full payload stream.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import algorithms
from repro_torch.core.engine import PMVEngine, StepConfig, placement_call, resolve_device
from repro_torch.core.gimv import GimvSpec
from repro_torch.serving.batcher import (
    DEFAULT_BUCKETS,
    RETIREMENT_REASONS,
    Query,
    QueryBatcher,
    QueryResult,
)

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


def make_batched_step(spec: GimvSpec, cfg: StepConfig, *, delta_kind: str = "abs"):
    """Build step(matrix, v, ctx, mask, active) -> (v_new, deltas [Q], stats).

    v/ctx carry a trailing query axis ([b, n_local, Q]).  ``active`` [Q]
    (a bool tensor on v's device) freezes retired / padded columns: their v
    entries pass through unchanged, so a column can sit retired while the
    rest of the batch keeps iterating.
    """

    def step(matrix, v, ctx, mask, active):
        v_new, _r, stats = placement_call(spec, cfg, matrix, v, ctx, mask)
        v_new = torch.where(active, v_new, v)  # broadcast over the trailing Q axis
        return v_new, per_query_delta(v, v_new, delta_kind=delta_kind), stats

    return step


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
    blocked_ids: torch.Tensor   # [b * n_local] global id of each blocked slot, n for padding
    global_pos: torch.Tensor    # [n] blocked slot of each global id


def _not_ported(knob: str, detail: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"PMVServer knob {knob} is not supported by repro_torch yet" + (f" ({detail})" if detail else ""))


# per-iteration stats summed into stats()
_SUMMED = ("gathered_elems", "exchanged_elems", "logical_elems")


class PMVServer:
    """Multi-query GIM-V serving over one resident pre-partitioned matrix.

    submit() enqueues queries; drain() packs them into Q-bucket batches per
    family, iterates the batched step with per-query convergence tracking,
    and continuously admits waiting queries into retired columns.  The
    partition, plan and device-resident matrix are built once per family
    (its engine's ``prepare``) and cached across batches and drain calls.

    device: None (the GPU; raises without one) | 'cuda' | 'cpu', as for
    :class:`PMVEngine`.  The other engine knobs (strategy, theta, psi,
    exchange, capacity, backend, scatter, stream, base_weights) are passed
    to each family's engine.  ``stats()['iter_wall_s']`` holds the host
    walls of the most recent batched iterations (each ends with the one
    device->host copy of the iteration's deltas).
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
        slack: float | None = None,
        payload_dtype: str | None = None,
        backend: str = "torch",
        scatter: str = "auto",
        stream: str = "auto",
        base_weights: np.ndarray | None = None,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        max_iters: int = 200,
        mesh=None,
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
        if store is not None:
            raise _not_ported("store")
        if residency != "device" or store_budget_bytes is not None:
            raise _not_ported(f"residency={residency!r} / store_budget_bytes")
        if mesh is not None:
            raise _not_ported("mesh", "emulation mode only")
        if obs:
            raise _not_ported("obs")
        if faults is not None:
            raise _not_ported("faults")
        if io_retry is not None:
            raise _not_ported("io_retry")
        if telemetry:
            raise _not_ported("telemetry")
        if exchange == "hier":
            raise _not_ported(f"exchange={exchange!r}")
        if slack is not None:
            raise _not_ported("slack", "it sizes capacity='model', which is not ported")
        if edges is None or n is None or b is None:
            raise ValueError("PMVServer needs (edges, n, b=)")
        self.device = resolve_device(device)
        self.edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.n = int(n)
        self.b = int(b)
        self.max_iters = int(max_iters)
        self._engine_kwargs = dict(
            strategy=strategy, theta=theta, psi=psi, exchange=exchange,
            capacity=capacity, payload_dtype=payload_dtype, backend=backend,
            scatter=scatter, stream=stream, base_weights=base_weights,
            device=self.device)
        # the engine checks its own knobs: fail here, not at the first batch
        PMVEngine(self.edges, self.n, b=self.b, **self._engine_kwargs)
        # admission control: queries submitted while >= max_queue are waiting
        # are shed immediately (reason='shed').  None = accept everything.
        self.max_queue = max_queue
        self._batcher = QueryBatcher(buckets)
        self._families: dict[tuple, _FamilyState] = {}
        self._results: dict[int, QueryResult] = {}
        self._next_qid = 0
        self._occupancy_sum = 0.0              # sum over batches of |queries|/Q
        self._retirement_reasons = {r: 0 for r in RETIREMENT_REASONS}
        self._iter_walls: collections.deque = collections.deque(maxlen=self._ITER_WALLS_KEPT)
        self._stats = {
            "batches": 0, "queries": 0, "admitted_mid_batch": 0,
            "overflow_fallbacks": 0, "retired": 0, "requeued": 0,
            "shed": 0, "failed_batches": 0,
            "queue_wait_s": 0.0,
            "iterations": 0.0, "gathered_elems": 0.0, "exchanged_elems": 0.0,
            "logical_elems": 0.0, "wall_s": 0.0,
        }

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
            return qid
        self._batcher.add(query)
        return qid

    def _retire_unserved(self, query: Query, reason: str, error: str | None = None) -> None:
        """Record a result for a query whose column never (or no longer)
        iterates: shed at admission or lost to a failed batch."""
        self._results[query.qid] = QueryResult(
            qid=query.qid, query=query, vector=None, iterations=0, converged=False,
            latency_s=time.perf_counter() - query.t_submit, reason=reason, error=error)
        self._retirement_reasons[reason] += 1

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
        ledger -- ``retired`` answered columns, total ``queue_wait_s``, mean
        ``batch_occupancy`` (real queries / bucket capacity) and the recent
        batched-iteration walls ``iter_wall_s``.  ``overflow_fallbacks``,
        ``requeued`` and ``fallback_events`` stay empty: the structural
        capacity cannot overflow, and an overflow would raise."""
        out = dict(self._stats)
        out["fallback_events"] = []
        out["retirement_reasons"] = dict(self._retirement_reasons)
        out["batch_occupancy"] = (
            self._occupancy_sum / out["batches"] if out["batches"] else 0.0)
        out["iter_wall_s"] = list(self._iter_walls)
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
        matrices."""
        self._families.clear()

    # ------------------------------------------------------------------
    def _family_state(self, key: tuple, sample: Query) -> _FamilyState:
        if key not in self._families:
            family = FAMILIES[sample.spec_kind]
            spec = family.make_spec(self.n, sample)
            engine = PMVEngine(self.edges, self.n, b=self.b, symmetrize=family.symmetrize,
                               **self._engine_kwargs)
            matrix, _v0, _ctx, mask, meta = engine.prepare(spec)
            step = make_batched_step(spec, meta["cfg"], delta_kind=family.delta_kind)
            part = meta["part"]
            ids = np.minimum(part.global_ids_grid().reshape(-1), self.n)
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
        """Global columns [n] -> the blocked batch [b, n_local, k] on the device.
        The columns go over stacked whole and one gather on the device blocks
        them (padding slots get 0, as Partition.to_blocked gives them): a
        host write of each column into [b, n_local, Q] would touch a new
        cache line per element."""
        x = torch.from_numpy(np.stack(cols)).to(self.device)               # [k, n]
        x = torch.cat([x, x.new_zeros((x.shape[0], 1))], dim=1)            # column n: 0
        return x[:, st.blocked_ids].T.reshape(self.b, st.part.n_local, -1).contiguous()

    def _global(self, st: _FamilyState, v: torch.Tensor, slots: list[int]) -> np.ndarray:
        """Columns ``slots`` of the blocked batch -> [len(slots), n] on the host."""
        cols = v.index_select(2, torch.tensor(slots, device=self.device))  # [b, n_local, r]
        flat = cols.reshape(-1, len(slots)).index_select(0, st.global_pos)  # [n, r]
        return flat.T.contiguous().cpu().numpy()

    def _run_batch(self, key: tuple, batch: list[Query]) -> None:
        try:
            self._run_batch_inner(key, batch)
        except OSError as e:
            # The batch is lost, but the SERVER is not: every unanswered query
            # in it retires with reason='failed' and the error's text, and
            # later batches proceed.
            self._stats["failed_batches"] += 1
            self._families.pop(key, None)  # state may be half-built
            for query in batch:
                if query.qid not in self._results:
                    self._retire_unserved(query, "failed", error=str(e))

    def _run_batch_inner(self, key: tuple, batch: list[Query]) -> None:
        st = self._family_state(key, batch[0])
        dev = self.device
        n_q = self._batcher.bucket_for(len(batch))
        self._stats["batches"] += 1
        self._occupancy_sum += len(batch) / n_q

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
            active_t = torch.from_numpy(active).to(dev)
            v_new, deltas, stats = st.step(st.matrix, v, ctx, st.mask, active_t)
            # one device->host copy per iteration for the per-query deltas and
            # every scalar the iteration produced (it also waits for the step)
            keys = [k for k, x in stats.items() if isinstance(x, torch.Tensor)]
            host = torch.cat([deltas.to(torch.float32)]
                             + [stats[k].to(torch.float32).reshape(1) for k in keys]).tolist()
            deltas_h = np.asarray(host[:n_q])
            scalars = {k: float(x) for k, x in stats.items() if not isinstance(x, torch.Tensor)}
            scalars.update(zip(keys, host[n_q:]))
            iter_wall = time.perf_counter() - t0
            self._iter_walls.append(iter_wall)
            self._stats["wall_s"] += iter_wall
            self._stats["iterations"] += 1
            for k in _SUMMED:
                self._stats[k] += scalars.get(k, 0.0)
            if scalars.get("overflow", 0.0) > 0:
                # A truncated exchange would silently corrupt EVERY in-flight
                # column (the shared index set unions rows across queries).
                # The JAX package rebuilds the family with an overflow-free
                # fallback; the port has only capacity='structural', which
                # cannot overflow, so there is no fallback to take and this
                # raises, as the JAX package does when none exists.
                lost = sorted(q.qid for q in slots if q is not None)
                raise RuntimeError(
                    "sparse exchange overflow in batched serving: capacity "
                    f"{st.meta['capacity']} too small for the query batch; "
                    f"unanswered qids in this batch: {lost}")
            iters[active] += 1

            # columns that retire this iteration: converged, capped or expired
            now = time.perf_counter()
            retiring = []
            for q_i in np.nonzero(active)[0]:
                done = bool(deltas_h[q_i] < tols[q_i])
                expired = not done and now > dls[q_i]
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
                self._results[query.qid] = QueryResult(
                    qid=query.qid, query=query, vector=answers[j],
                    iterations=int(iters[q_i]), converged=done,
                    latency_s=time.perf_counter() - query.t_submit, reason=reason)
                self._retirement_reasons[reason] += 1
                self._stats["retired"] += 1
                self._stats["queue_wait_s"] += max(0.0, starts[q_i] - query.t_submit)
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
