"""PMVEngine: pre-partition once, iterate M (x) v to convergence (paper §3.1).

Two modes, as in the JAX package:

- emulation (``mesh=None``): all b workers' shards live on one device with
  an explicit leading worker axis (placement.py);
- SPMD (``mesh=`` a ``torch.distributed.device_mesh.DeviceMesh``): one
  process (rank) per worker, started as under ``torchrun``.  Every rank
  builds the same engine and calls ``run`` collectively; each runs the same
  deterministic host prepare, keeps its own worker's rows of the matrix, the
  vector, the context and the mask (a leading worker axis of length 1), and
  the exchanges cross the process boundaries through ``core/collectives.py``
  (NCCL on GPUs, gloo on the CPU).  The convergence delta and the counted
  stats are summed over the workers, so every rank reports the same
  iterations and the whole vector.

The engine runs on the GPU unless the caller passes ``device='cpu'``, where
every kernel wrapper takes its plain PyTorch version; under a mesh a rank's
GPU is ``cuda:{LOCAL_RANK % device_count()}``.

Per iteration the engine reports *physical* communicated elements (the
static buffers an exchange would move) and *logical* elements (value-level
non-identity entries, the paper's I/O metric).

``placement_call`` and ``StepConfig`` also serve the multi-query step of
``repro_torch.serving``: v and ctx may carry a trailing query axis.

``exchange='packed'`` derives the per-(source, destination) row sets once at
prepare (``repro_torch.exchange``) and ships only payloads each iteration;
``delta_eps`` then re-sends only the rows that moved, carrying the last
shipped payload from one iteration to the next.

``store=`` runs against an ingested out-of-core block store
(``repro_torch.store``) instead of an in-memory edge list: ``residency``
'device' / 'host' load it back (bitwise ``partition_graph``), 'disk' never
materializes the stripes and streams one block's shard slice at a time
(``repro_torch.store.residency``).

``obs=`` traces the run (``repro_torch.obs``): the prepare phases
(``prepare.*`` spans), the plan gauges, one fenced ``pmv.iteration`` span
per iteration with its per-iteration series, and out of core the store's
and the disk executor's spans and counters.  Off, it is the no-op
``NULL_RECORDER`` and the solve is bitwise what it is untraced; on, too,
since a fence only waits for the device.

Fault tolerance, as in the JAX package: ``run(checkpoint_dir=,
checkpoint_every=, resume=)`` commits the blocked iterate atomically to
``pmv_state.npz`` (the JAX package's file: ``v`` [b, n_local] in the spec's
dtype and ``it``; either package resumes the other's); ``faults=`` (a
``repro_torch.faults`` plan or injector) injects a kill at an iteration
boundary and, through every disk store the engine builds, fetch faults;
``capacity='model'`` sizes the compact exchange from the cost model and an
overflowing run is retried once on an overflow-free configuration
(``fallback_overrides``).
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.core import blocks as blocks_lib
from repro_torch.core import collectives, cost_model, placement, planner
from repro_torch.core.gimv import GimvSpec
from repro_torch.core.partition import HybridMatrix, Partition, PartitionedMatrix, partition_graph
from repro_torch.exchange import plan as exchange_plan
from repro_torch.faults import RetryPolicy, as_injector
from repro_torch.graph.generators import symmetrize_edges
from repro_torch.graph.stats import compute_stats
from repro_torch.kernels.block_gimv import has_semiring, semiring_of
from repro_torch.obs.recorder import as_recorder

__all__ = ["PMVEngine", "PMVResult", "StepConfig", "placement_call", "resolve_device",
           "CheckpointCorruptError", "CheckpointCorruptWarning"]

BACKENDS = ("torch", "auto")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static per-step configuration, derived from the ExecutionPlan.
    ``backend`` is the resolved mode: 'torch' | 'planned'."""

    strategy: str            # 'horizontal' | 'vertical' | 'hybrid'
    n_local: int
    exchange: str = "sparse"  # resolved transport: 'sparse' | 'dense' | 'packed'
    capacity: int | None = None
    backend: str = "torch"
    plan: planner.ExecutionPlan | None = None
    # packed exchange: the static byte-model plan, and the resolved
    # delta-iteration threshold (None = full stream; set only where the
    # semiring admits suppression, see PMVEngine._resolve_exchange).
    xplan: exchange_plan.ExchangePlan | None = None
    delta_eps: float | None = None
    # wire dtype of the exchanged values (e.g. 'bfloat16'); None ships the
    # spec dtype.  Accumulation stays in the spec dtype.
    payload_dtype: str | None = None


def _wire_dtype(name: str | None) -> torch.dtype | None:
    """The torch dtype a ``payload_dtype`` name ('bfloat16', 'float16', ...)
    stands for; None for None."""
    if name is None:
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"payload_dtype {name!r} is not a dtype")
    return dt


def placement_call(spec: GimvSpec, cfg: StepConfig, matrix: dict, v, ctx, mask,
                   xstate=None, *, axis=None):
    """Dispatch one placement step for ``cfg.strategy`` -> (v_new, r, stats),
    plus the new delta-iteration state as a fourth element when ``xstate``
    (the previously shipped packed payload) is passed.  ``axis`` (a
    ``collectives.WorkerAxis``) runs the step as this rank's worker of an
    SPMD solve; None, as the emulated one of every worker."""
    scatter = cfg.plan.scatter if cfg.plan is not None else "segment"
    wire = _wire_dtype(cfg.payload_dtype)
    if cfg.strategy == "horizontal":
        return placement.horizontal_step(
            spec, matrix.get("stripe"), v, ctx, mask, n_local=cfg.n_local,
            planned=matrix.get("planned"), backend=cfg.backend, axis=axis)
    if cfg.strategy == "vertical":
        return placement.vertical_step(
            spec, matrix.get("stripe"), v, ctx, mask, n_local=cfg.n_local,
            exchange=cfg.exchange, capacity=cfg.capacity,
            planned=matrix.get("planned"), streamed=matrix.get("streamed"),
            backend=cfg.backend, scatter=scatter, xchg=matrix.get("xchg"), xplan=cfg.xplan,
            delta_eps=cfg.delta_eps, delta_state=xstate, payload_dtype=wire, axis=axis)
    if cfg.strategy == "hybrid":
        return placement.hybrid_step(
            spec, matrix.get("sparse_stripe"), matrix.get("dense_stripe"),
            matrix["dense_region"], v, ctx, mask, n_local=cfg.n_local,
            capacity=cfg.capacity, planned_sparse=matrix.get("planned_sparse"),
            streamed_sparse=matrix.get("streamed_sparse"), dense_matrix=matrix.get("dense_matrix"),
            backend=cfg.backend, scatter=scatter, exchange=cfg.exchange, xchg=matrix.get("xchg"),
            xplan=cfg.xplan, payload_dtype=wire, axis=axis)
    raise ValueError(cfg.strategy)


@dataclasses.dataclass
class PMVResult:
    v: np.ndarray
    iterations: int
    converged: bool
    strategy: str
    theta: float | None
    capacity: int | None
    per_iter: list[dict]
    totals: dict

    @property
    def deltas(self) -> np.ndarray:
        """Per-iteration convergence-delta trajectory."""
        return np.asarray([r["delta"] for r in self.per_iter])


def resolve_device(device) -> torch.device:
    """None -> the GPU, raising when there is none; otherwise the named
    device, raising for 'cuda' without a GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PMVEngine runs on the GPU by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _not_ported(knob: str, detail: str = "") -> NotImplementedError:
    return NotImplementedError(
        f"PMVEngine knob {knob} is not supported by repro_torch yet" + (f" ({detail})" if detail else ""))


class PMVEngine:
    """Scalable GIM-V engine with pre-partitioning + placement selection.

    strategy: 'horizontal' | 'vertical' | 'selective' (Eq. 5 pick between the
      two basics; 'auto' is an alias) | 'hybrid' (θ-split).
    theta: float or 'auto' (θ* of Lemma 3.3).
    exchange: 'sparse' (compacted) | 'dense' (full partials) | 'packed'
      (repro_torch.exchange: per-(src, dst) row sets derived once at
      prepare, ids shipped once, each iteration ships payloads only) |
      'hier' (the vertical placement's two-hop exchange: compacted partials
      folded within each pod, then the combined rows across the pods; needs
      a mesh and a tuple ``axis_name`` (pod, *inner) of at least two dims,
      else ValueError; the hybrid's sparse region keeps the compact one) |
      'auto' (packed when ``cost_model.prefer_packed_exchange`` says its
      amortized bytes undercut the padded stream's, else sparse).  The
      horizontal placement exchanges no partials: 'packed' / 'auto' resolve
      to 'sparse' there.  meta['exchange'] / ['exchange_decision'] record it.
    delta_eps: delta iteration over the packed exchange: re-send only rows
      that moved more than delta_eps since the last send (0.0: any bitwise
      change, exact).  Active only for a vertical packed solve whose
      combineAll is 'sum' over a float type; meta['delta_reason'] says why
      not otherwise.
    capacity: 'structural' (exact max partial nnz, overflow-free) | 'model'
      (the cost model's Eq. 4 / Eq. 8 expected partial nnz x ``slack``:
      tighter, may overflow; an overflowing run is retried once on an
      overflow-free configuration, ``fallback_overrides``, and
      totals['fallback'] names it).  As in the JAX package, any value other
      than 'structural' sizes the capacity from the model.
    payload_dtype: wire dtype of the exchanged values (e.g. 'bfloat16'):
      the compact and packed exchanges cast their values to it before they
      ship (before the delta test under delta iteration) and back to the
      spec dtype before the receive fold, so accumulation stays in the spec
      dtype; the wire byte counts use its itemsize.  Not supported out of
      core (ValueError, as in the JAX package).
    backend: 'torch' (plain tensor ops) | 'auto' (the per-block planner with
      the ELL / dense / scatter-combine kernels).  A spec whose
      (combine2, combineAll) pair has no kernel semiring resolves to 'torch',
      recorded in meta['backend'].
    scatter: receive side of the sparse and packed exchanges -- 'segment' |
      'kernel' | 'auto' (the cost model's crossover).
    stream: 'auto' | 'on' | 'off': the planned vertical / hybrid partial
      schedule.  'on' runs the bucket-streamed executor (one destination
      block at a time, each partial compacted or payload-gathered as it is
      produced: O(n_local + b*cap) live per worker where the fused 'off'
      schedule holds all b partials); 'auto' streams where
      ``cost_model.prefer_streamed`` says so.  A forced 'on' resolves to
      'off' where nothing streams (horizontal, the dense exchange,
      backend='torch'), as in the JAX package.  meta['plan'].stream and
      ``plan.memory_profile()`` record it.
    device: None (the GPU; raises without one) | 'cuda' | 'cpu'.
    store / residency: run against an out-of-core pre-partitioned block
      store (``repro_torch.store``) in place of an edge list.  ``store`` is
      a store directory or Manifest (n, b and psi come from it);
      ``residency`` picks the matrix home: 'device' loads the shards back
      (bitwise ``partition_graph``) onto the engine's device; 'host' the
      same, with the matrix kept in pinned host memory and copied to the
      GPU inside each step (on the CPU the same as 'device'); 'disk' never
      materializes the stripes: the solve walks the plan's block schedule,
      fetching one block's shard slice at a time with double-buffered
      prefetch, bitwise the resident backend='torch' step on the CPU
      (vertical with the sparse or packed exchange, horizontal, or the
      θ-split hybrid from the shards ``ingest_edges(theta=...)`` wrote; the
      disk path plans and runs as backend 'torch', its receive tail takes
      the scatter kernels under scatter='kernel').  ``store_budget_bytes``
      bounds the resident slice bytes of each striping read under 'disk';
      ``io_retry`` (a ``repro_torch.faults.RetryPolicy``) bounds every
      disk fetch.
    obs: None / False (the zero-overhead null recorder), True (a fresh
      ``repro_torch.obs.Recorder``), or a Recorder shared with a server or
      another engine, so one trace covers the run.
    faults: None, a ``repro_torch.faults.FaultPlan`` (built once into an
      injector) or a FaultInjector shared with a server or a resumed run:
      its consumed events stay consumed, so a kill fired by one ``run()``
      does not fire again when the caller resumes.  Every disk store the
      engine builds injects its fetch faults.
    mesh / axis_name: SPMD, one rank per worker (module doc).  ``mesh`` is
      a ``DeviceMesh`` with named dims, built after ``init_process_group``;
      ``axis_name`` names its worker dims (a name, or a tuple such as
      ('pod', 'workers')), and a rank owns the worker whose index is its
      row-major coordinate over them.  ``b`` must equal their size
      (ValueError naming both); a mesh dim outside ``axis_name`` raises
      NotImplementedError, as do residency 'host' and 'disk' under a mesh.
      A checkpoint is gathered and written by worker 0 and read by every
      rank.

    The JAX package's other knobs (backend='pallas' / 'xla') raise
    NotImplementedError naming the knob.
    """

    def __init__(
        self,
        edges: np.ndarray | None,
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
        delta_eps: float | None = None,
        backend: str = "torch",
        scatter: str = "auto",
        stream: str = "auto",
        symmetrize: bool = False,
        base_weights: np.ndarray | None = None,
        mesh=None,
        axis_name="workers",
        store=None,
        residency: str = "device",
        store_budget_bytes: int | None = None,
        obs=None,
        faults=None,
        io_retry: RetryPolicy | None = None,
        device=None,
    ):
        if residency not in cost_model.RESIDENCY_MODES:
            raise ValueError(f"residency must be one of {cost_model.RESIDENCY_MODES}, "
                             f"got {residency!r}")
        if exchange not in ("sparse", "dense", "packed", "hier", "auto"):
            raise ValueError(f"unknown exchange {exchange!r}")
        if delta_eps is not None and not delta_eps >= 0.0:
            raise ValueError(f"delta_eps must be >= 0, got {delta_eps}")
        if backend not in BACKENDS:
            if backend in ("pallas", "xla"):
                raise _not_ported(f"backend={backend!r}", "use 'torch' or 'auto'")
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if scatter not in ("auto", "segment", "kernel"):
            raise ValueError(scatter)
        if stream not in ("auto", "on", "off"):
            raise ValueError(stream)
        self.store = None
        self.residency = residency
        self.store_budget_bytes = store_budget_bytes
        self.io_retry = io_retry
        self.obs = as_recorder(obs)
        # shared by every store this engine builds and by a fallback engine
        self._fault_injector = as_injector(faults, self.obs)
        if store is not None:
            from repro_torch.store import open_store

            self.store = open_store(store)
            if edges is not None:
                raise ValueError("pass either edges or store=, not both")
            if n is not None and int(n) != self.store.n:
                raise ValueError(f"n={n} does not match the store's n={self.store.n}")
            if b is not None and int(b) != self.store.b:
                raise ValueError(f"b={b} does not match the store's b={self.store.b}")
            if psi is not None and psi != self.store.psi:
                raise ValueError(
                    f"psi={psi!r} does not match the store's psi={self.store.psi!r}")
            if symmetrize and not self.store.symmetrized:
                raise ValueError(
                    "symmetrize=True but the store was ingested without "
                    "symmetrize — re-ingest with ingest_edges(symmetrize=True)")
            if base_weights is not None:
                raise ValueError("base_weights are not persisted by the store")
            n, b, psi = self.store.n, self.store.b, self.store.psi
        else:
            if edges is None or n is None or b is None:
                raise ValueError("PMVEngine needs (edges, n, b=) or store=")
            if residency != "device":
                raise ValueError(
                    f"residency={residency!r} needs store= (an ingested "
                    "block-store directory; see repro_torch.store.ingest_edges)")
            if symmetrize:
                edges = symmetrize_edges(edges)
            edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.mesh, self.axis_name = mesh, axis_name
        self.axis = None
        if mesh is not None:
            if residency == "host":
                raise NotImplementedError(
                    "residency='host' under SPMD needs per-host shard serving; use "
                    "residency='device' with a mesh")
            if residency == "disk":
                raise NotImplementedError(
                    "residency='disk' under a mesh needs the per-worker disk groups "
                    "(SpmdDiskGroup), which repro_torch does not have yet")
            self.axis = collectives.worker_axis(mesh, axis_name)
            if self.axis.size != int(b):
                raise ValueError(f"b={int(b)} does not match the size {self.axis.size} of the "
                                 f"mesh dims {self.axis.names}: one rank runs one worker")
        if exchange == "hier":
            collectives.hier_groups(self.axis)
        self.device = (resolve_device(device) if self.axis is None
                       else collectives.rank_device(resolve_device(device)))
        self.edges = edges
        self.n = int(n)
        self.b = int(b)
        self.strategy = strategy
        self.theta = theta
        self.psi = psi or "cyclic"
        self.exchange = exchange
        self.capacity_mode = capacity
        self.slack = slack
        self.payload_dtype = payload_dtype
        self.delta_eps = delta_eps
        self.backend = backend
        self.scatter = scatter
        self.stream = stream
        self.base_weights = base_weights
        self._prep_cache: dict = {}

    _PREP_CACHE_MAX = 8

    @classmethod
    def from_store(cls, store, **kwargs) -> "PMVEngine":
        """Engine over an ingested block store (path or Manifest); n, b and
        psi come from the manifest.  ``residency`` defaults to 'host'."""
        kwargs.setdefault("residency", "host")
        return cls(None, store=store, **kwargs)

    def _num_edges(self) -> int:
        return self.store.m if self.store is not None else self.edges.shape[0]

    def _graph_stats(self):
        if self.store is not None:
            return self.store.graph_stats()
        return compute_stats(self.edges, self.n)

    def resolve_strategy(self) -> tuple[str, float | None]:
        m = self._num_edges()
        if self.strategy in ("horizontal", "vertical"):
            return self.strategy, None
        if self.strategy in ("auto", "selective"):
            return cost_model.select_strategy(self.b, self.n, m), None
        if self.strategy == "hybrid":
            if self.theta == "auto":
                theta, _ = cost_model.theta_star(self.b, self.n, self._graph_stats())
            else:
                theta = float(self.theta)
            return "hybrid", theta
        raise ValueError(self.strategy)

    def _resolve_backend(self, spec: GimvSpec) -> str:
        """'auto' -> 'planned' when the spec's semiring has kernels, else 'torch'."""
        if self.backend == "auto" and has_semiring(spec.combine2, spec.combine_all):
            return "planned"
        return "torch"

    def _resolve_stream(self, strategy: str, backend: str, capacity: int | None,
                        part: Partition) -> str:
        """Resolve the streaming knob as the JAX package does.  Only the
        planned vertical/hybrid path with a compact, two-hop or packed
        exchange has partials to stream: the horizontal step never
        materializes partials, the dense exchange ships them whole and the
        'torch' backend has no streamed form, so there a forced 'on'
        resolves to 'off'.  'auto' asks the cost model's memory crossover
        (small b keeps the fused launches)."""
        streamable = (backend == "planned" and capacity is not None and
                      (strategy == "hybrid" or
                       (strategy == "vertical" and
                        self.exchange in ("sparse", "hier", "packed", "auto"))))
        if not streamable:
            return "off"
        if self.stream == "auto":
            return ("on" if cost_model.prefer_streamed(self.b, part.n_local, capacity)
                    else "off")
        return self.stream

    def _capacity(self, pm: PartitionedMatrix, hm: HybridMatrix | None) -> int:
        if self.capacity_mode == "structural":
            return hm.sparse_partial_cap if hm is not None else pm.partial_cap
        return cost_model.capacity_from_cost_model(
            self.b, self.n, self._num_edges(), stats=pm.stats,
            theta=hm.theta if hm is not None else None, slack=self.slack)

    def _disk_capacity(self, structural: int, theta: float | None) -> int:
        """The out-of-core capacity: the store's structural one, or the
        model's from the manifest's persisted graph stats."""
        if self.capacity_mode == "structural":
            return structural
        return cost_model.capacity_from_cost_model(
            self.b, self.n, self._num_edges(), stats=self.store.graph_stats(), theta=theta,
            slack=self.slack)

    def _wire_itemsize(self, spec: GimvSpec) -> int:
        """Bytes of one exchanged value: the payload dtype's, else the spec's."""
        wire = _wire_dtype(self.payload_dtype)
        return wire.itemsize if wire is not None else np.dtype(spec.dtype).itemsize

    def _put(self, a, dtype=None, device=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=device or self.device, dtype=dtype or t.dtype)

    @property
    def _matrix_home(self) -> torch.device:
        """Where the prepared matrix lives: the host under residency='host'
        (pinned at the end of prepare, copied to the GPU inside each step),
        else the engine's device."""
        return torch.device("cpu") if self.residency == "host" else self.device

    def own_rows(self, per_worker):
        """The entries of a per-worker sequence (a list, a range, or the rows
        of a per-worker array) this process holds: all b in emulation, its
        worker's one (a leading axis of length 1) under a mesh."""
        if self.axis is None:
            return per_worker
        w = self.axis.index
        return per_worker[w:w + 1]

    def _put_stripe(self, stripes: list) -> blocks_lib.BlockEdges:
        s = blocks_lib.stack_stripes(self.own_rows(stripes))
        home = self._matrix_home
        return blocks_lib.BlockEdges(
            seg_local=self._put(s.seg_local, torch.int64, home),
            gat_local=self._put(s.gat_local, torch.int64, home),
            w=None if s.w is None else self._put(s.w, device=home),
            count=self._put(s.count, torch.int64, home))

    def prepare(self, spec: GimvSpec, ctx: dict | None = None):
        """Pre-partitioning (once per spec, cached): returns (matrix, v0,
        ctx_blocked, real_mask, meta), everything on the engine's device.
        meta['prepare_s'] is the host time the partition, plan and packing
        took (device transfer included)."""
        if spec not in self._prep_cache:
            self._prep_cache[spec] = self._prepare_static(spec)
            while len(self._prep_cache) > self._PREP_CACHE_MAX:
                self._prep_cache.pop(next(iter(self._prep_cache)))
        matrix, real_mask, meta = self._prep_cache[spec]
        part = meta["part"]
        ids = part.global_ids_grid()
        ctx = ctx or {}
        v0 = spec.init(ids.reshape(-1), ctx).reshape(ids.shape).astype(spec.dtype)
        ctx_blocked = {k: self._put(self.own_rows(part.to_blocked(np.asarray(x))))
                       for k, x in ctx.items()}
        return matrix, self._put(self.own_rows(v0)), ctx_blocked, real_mask, meta

    def _prepare_static(self, spec: GimvSpec):
        t0 = time.perf_counter()
        strategy, theta = self.resolve_strategy()
        if self.store is not None and self.residency == "disk":
            return self._prepare_disk(spec, strategy, theta, t0)
        rec = self.obs
        with rec.span("prepare.partition") as sp:
            sp.set("spec", spec.name)
            sp.set("strategy", strategy)
            if self.store is not None:
                from repro_torch.store import load_partitioned

                pm, hm = load_partitioned(self.store, spec,
                                          theta=theta if strategy == "hybrid" else None)
            else:
                pm, hm = partition_graph(self.edges, self.n, self.b, spec, psi=self.psi,
                                         base_weights=self.base_weights,
                                         theta=theta if strategy == "hybrid" else None)
        part = pm.part
        nl = part.n_local
        backend = self._resolve_backend(spec)
        home = self._matrix_home
        matrix: dict = {}
        # the stripe tables and the dense region; unlike the JAX package's
        # span, this one includes their host-to-device copies (_put uploads
        # each table as it is built)
        with rec.span("prepare.stripes"):
            if strategy == "horizontal":
                capacity = None
                if backend == "torch":
                    matrix["stripe"] = self._put_stripe(pm.horizontal)
            elif strategy == "vertical":
                capacity = self._capacity(pm, None)
                if backend == "torch":
                    matrix["stripe"] = self._put_stripe(pm.vertical)
            else:
                capacity = self._capacity(pm, hm)
                matrix["dense_region"] = blocks_lib.DenseRegion(
                    gather_idx=self._put(self.own_rows(hm.dense.gather_idx), torch.int64, home),
                    d_count=self._put(self.own_rows(hm.dense.d_count), device=home),
                    d_cap=hm.dense.d_cap, theta=hm.dense.theta)
                if backend == "torch":
                    matrix["sparse_stripe"] = self._put_stripe(hm.sparse_vertical)
                    matrix["dense_stripe"] = self._put_stripe(hm.dense_horizontal)
                else:
                    # the dense REGION is a region-level dense tactic (§3.5):
                    # materialized once, one dense kernel launch per iteration.
                    semiring = semiring_of(spec.combine2, spec.combine_all)
                    dm = np.stack([blocks_lib.materialize_dense_matrix(s, nl, hm.dense.d_cap,
                                                                       semiring)
                                   for s in self.own_rows(hm.dense_horizontal)])
                    matrix["dense_matrix"] = self._put(dm.reshape(dm.shape[0] * nl, -1),
                                                       device=home)
                    del dm

        scatter = self.scatter if has_semiring(spec.combine2, spec.combine_all) else "segment"
        stream = self._resolve_stream(strategy, backend, capacity, part)
        with rec.span("prepare.plan") as sp:
            plan = planner.plan_execution(
                pm, hm, strategy=strategy, mode=backend, theta=theta, capacity=capacity,
                scatter=scatter, stream=stream, interpret=self.device.type != "cuda",
                residency=self.residency)
            sp.set("mode", backend)
            sp.set("predicted_slots", plan.planned_slots)
        self._record_plan_metrics(plan)
        # pack, stack and flatten the planned tables (under a mesh only this
        # rank's worker's); this span includes their host-to-device copies
        # (flatten_planned / flatten_streamed upload), which the JAX
        # package's makes at prepare.device_put
        workers = self.own_rows(range(self.b))
        with rec.span("prepare.pack"):
            if backend == "planned":
                semiring = semiring_of(spec.combine2, spec.combine_all)
                if strategy == "horizontal":
                    stripes, layout, key = pm.horizontal, "merged", "planned"
                elif strategy == "vertical":
                    stripes, layout, key = pm.vertical, "vertical", "planned"
                else:
                    stripes, layout, key = hm.sparse_vertical, "vertical", "planned_sparse"
                if stream == "on":
                    # block-major (worker_axis=1): step k of the streamed
                    # executor reads views [k] of every bucket
                    packed = blocks_lib.stack_streamed([
                        blocks_lib.pack_streamed_stripe(
                            stripes[w], plan.tactics_for_worker(w, layout), nl,
                            boundaries=plan.boundaries, semiring=semiring)
                        for w in workers], semiring, worker_axis=1)
                    matrix[key.replace("planned", "streamed")] = placement.flatten_streamed(
                        packed, nl, len(workers), home)
                else:
                    packed = blocks_lib.stack_planned([
                        blocks_lib.pack_planned_stripe(
                            stripes[w], plan.tactics_for_worker(w, layout), nl, layout=layout,
                            boundaries=plan.boundaries, semiring=semiring)
                        for w in workers], semiring)
                    matrix[key] = placement.flatten_planned(packed, nl, len(workers), home)
                del packed
        exchange, xplan, delta_eps, xmeta = self._resolve_exchange(
            spec, strategy, capacity, plan,
            pm.vertical if strategy == "vertical" else
            (hm.sparse_vertical if hm is not None else None),
            part, matrix)
        cfg = StepConfig(strategy=strategy, n_local=nl, exchange=exchange,
                         capacity=capacity, backend=backend, plan=plan, xplan=xplan,
                         delta_eps=delta_eps, payload_dtype=self.payload_dtype)
        # the mask, the pinning and the wait for every queued copy
        with rec.span("prepare.device_put"):
            real_mask = self._put(self.own_rows(part.global_ids_grid() < self.n))
            if self.residency == "host" and self.device.type == "cuda":
                matrix = _tree_map(lambda t: t.pin_memory(), matrix)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        meta = {
            "strategy": strategy, "theta": theta, "capacity": capacity, "part": part,
            "pm": pm, "hm": hm, "cfg": cfg, "backend": backend, "plan": plan,
            "residency": self.residency, "device": str(self.device),
            "n_dense": int(hm.dense.d_count.sum()) if hm is not None else 0,
            "prepare_s": time.perf_counter() - t0,
            **xmeta,
        }
        return matrix, real_mask, meta

    def _record_plan_metrics(self, plan: planner.ExecutionPlan) -> None:
        """Plan-shape gauges: tactic mix, padding occupancy, predicted cost
        (prepare-time; one write per gauge, nothing on the hot path)."""
        rec = self.obs
        if not rec.enabled:
            return
        rec.gauge("plan.predicted_slots").set(plan.planned_slots)
        if plan.capacity is not None:
            rec.gauge("plan.capacity").set(plan.capacity)
        for tactic, count in plan.tactic_counts().items():
            rec.gauge(f"plan.tactic.{tactic}").set(count)
        occ = [bp.occupancy for bp in plan.blocks if bp.nnz]
        if occ:
            rec.gauge("plan.mean_occupancy").set(float(np.mean(occ)))
        if plan.residency == "disk":
            rec.gauge("plan.io_bytes_per_iter").set(plan.io_bytes_per_iter())

    def _resolve_exchange(self, spec: GimvSpec, strategy: str, capacity: int | None,
                          plan: planner.ExecutionPlan, stripes, part: Partition, matrix: dict):
        """Resolve self.exchange ('auto' weighs packed against the padded
        stream with the cost model) and, for 'packed', derive the static row
        sets from the block structure, put their arrays on the device as
        matrix['xchg'] (send_rows / recv_rows int32; recv_words uint32 under
        scatter='kernel'), and gate delta iteration.  Returns (exchange,
        xplan, delta_eps, meta_extra), as the JAX package resolves them."""
        exchange = self.exchange
        xplan = None
        delta_eps = None
        decision = "forced"
        if strategy == "horizontal":
            if exchange in ("packed", "auto"):
                exchange = "sparse"  # no partial exchange to pack
            return exchange, None, None, {"exchange": exchange, "exchange_decision": "n/a"}
        itemsize = self._wire_itemsize(spec)
        if exchange in ("packed", "auto"):
            with self.obs.span("prepare.exchange") as sp:
                row_sets = exchange_plan.row_sets_from_stripes(stripes, self.b)
                xp, arrays = exchange_plan.build_exchange(row_sets, part.n_local,
                                                          scatter=plan.scatter)
                sp.set("p_cap", xp.p_cap)
                sp.set("id_bytes", xp.id_bytes)
            if exchange == "auto":
                use_packed = cost_model.prefer_packed_exchange(
                    self.b, capacity, xp.payload_slots, xp.id_bytes, None, itemsize)
                exchange = "packed" if use_packed else "sparse"
                decision = ("auto: packed undercuts padded" if use_packed
                            else "auto: padded stream kept")
            if exchange == "packed":
                matrix["xchg"] = {k: self._put(self.own_rows(a), device=self._matrix_home)
                                  for k, a in arrays.items()}
                xplan = xp
        delta_reason = None
        if self.delta_eps is not None:
            if exchange != "packed":
                delta_reason = "needs exchange='packed'"
            elif strategy != "vertical":
                delta_reason = "vertical-only (hybrid keeps the full stream)"
            elif spec.combine_all != "sum":
                delta_reason = (f"combineAll={spec.combine_all!r} is exact "
                                "selection — full stream kept")
            elif not (_wire_dtype(self.payload_dtype) or spec.torch_dtype).is_floating_point:
                delta_reason = "integer payloads keep the full stream"
            else:
                delta_eps = float(self.delta_eps)
                delta_reason = "active"
        return exchange, xplan, delta_eps, {
            "exchange": exchange, "exchange_decision": decision,
            "delta_eps": delta_eps, "delta_reason": delta_reason,
        }

    def _prepare_disk(self, spec: GimvSpec, strategy: str, theta: float | None, t0: float):
        """residency='disk': never materialize the stripes -- plan from the
        manifest's persisted measurements and build the schedule-driven
        executor (repro_torch.store.residency) that streams shard slices
        block by block with double-buffered prefetch.  As in the JAX
        package it plans in the plain mode ('torch', the counterpart of
        'xla'), and a ``delta_eps`` keeps the full stream."""
        from repro_torch.store import DiskBlockStore, DiskExecutor, make_disk_step
        from repro_torch.store import plan_from_manifest

        if strategy == "hybrid":
            return self._prepare_disk_hybrid(spec, theta, t0)
        if strategy == "vertical" and self.exchange == "dense":
            raise ValueError(
                "residency='disk' streams through the compact sparse or "
                f"packed exchange; exchange={self.exchange!r} is not supported")
        if self.payload_dtype is not None:
            raise ValueError("payload_dtype is not supported out of core")
        part = Partition(n=self.n, b=self.b, psi=self.psi)
        capacity = (self._disk_capacity(self.store.partial_cap, None)
                    if strategy == "vertical" else None)
        scatter = self.scatter if has_semiring(spec.combine2, spec.combine_all) else "segment"
        rec = self.obs
        with rec.span("prepare.plan") as sp:
            sp.set("spec", spec.name)
            sp.set("strategy", strategy)
            plan = plan_from_manifest(
                self.store, strategy=strategy, mode="torch", theta=theta, capacity=capacity,
                scatter=scatter, stream="on" if strategy == "vertical" else "off",
                interpret=self.device.type != "cuda", residency="disk")
            sp.set("predicted_slots", plan.planned_slots)
        self._record_plan_metrics(plan)
        exchange, xplan, xchg, decision = self._resolve_disk_exchange(
            spec, strategy, capacity, plan, part)
        with rec.span("prepare.store"):
            dstore = DiskBlockStore(self.store, strategy, spec,
                                    budget_bytes=self.store_budget_bytes, device=self.device,
                                    obs=rec, faults=self._fault_injector)
            executor = DiskExecutor(spec, part, plan, dstore, capacity=capacity,
                                    scatter=plan.scatter, retry=self.io_retry, obs=rec,
                                    exchange=exchange, xchg=xchg, xplan=xplan)
        cfg = StepConfig(strategy=strategy, n_local=part.n_local, exchange=exchange,
                         capacity=capacity, backend="torch", plan=plan, xplan=xplan)
        real_mask = self._put(part.global_ids_grid() < self.n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        meta = {
            "strategy": strategy, "theta": theta, "capacity": capacity, "part": part,
            "pm": None, "hm": None, "cfg": cfg, "backend": "torch", "plan": plan,
            "residency": "disk", "store": dstore, "executor": executor,
            "step": make_disk_step(spec, executor), "device": str(self.device),
            "n_dense": 0, "prepare_s": time.perf_counter() - t0,
            "exchange": exchange, "exchange_decision": decision,
            "delta_eps": None,
            "delta_reason": (None if self.delta_eps is None
                             else "residency='disk' keeps the full stream"),
        }
        return dstore, real_mask, meta

    def _prepare_disk_hybrid(self, spec: GimvSpec, theta: float | None, t0: float):
        """strategy='hybrid' out of core, from the θ-split shards the ingest
        persisted (``ingest_edges(..., theta=...)`` writes the sparse_vertical
        and dense_horizontal stripings).  As in the JAX package: the schedule
        is structural (no planner plan; both legs fold independently of the
        launch order), the capacity covers the sparse region only, the
        exchange is the compact sparse stream (the packed index shards
        describe full vertical stripes, not the sparse region), and 'auto'
        scatter resolves to 'segment'.  Each leg reads its striping through
        its own DiskBlockStore under the same ``store_budget_bytes``."""
        from repro_torch.store import DiskBlockStore, HybridDiskExecutor, make_disk_step

        if self.payload_dtype is not None:
            raise ValueError("payload_dtype is not supported out of core")
        if self.exchange not in ("sparse", "auto"):
            raise ValueError(
                "hybrid out-of-core streams the compact sparse exchange; "
                f"exchange={self.exchange!r} is not supported (the packed "
                "index shards describe full vertical stripes, not the "
                "sparse region)")
        stored = self.store.hybrid_theta()   # raises if no θ-split shards
        if theta is not None and float(theta) != stored:
            raise ValueError(
                f"theta={theta} does not match the store's θ-split shards "
                f"(θ={stored}) — re-ingest with that θ, or pass "
                f"theta={stored} / theta='auto'")
        theta = stored
        part = Partition(n=self.n, b=self.b, psi=self.psi)
        capacity = self._disk_capacity(int(self.store.hybrid["sparse_partial_cap"]), theta)
        scatter = self.scatter if has_semiring(spec.combine2, spec.combine_all) else "segment"
        if scatter == "auto":
            scatter = "segment"
        region, _slot_of = self.store.dense_region()
        rec = self.obs
        with rec.span("prepare.store") as sp:
            sp.set("spec", spec.name)
            sp.set("strategy", "hybrid")
            kw = dict(budget_bytes=self.store_budget_bytes, device=self.device, obs=rec,
                      faults=self._fault_injector)
            sparse_store = DiskBlockStore(self.store, "sparse_vertical", spec, **kw)
            dense_store = DiskBlockStore(self.store, "dense_horizontal", spec,
                                         dense_gather_idx=region.gather_idx, **kw)
            executor = HybridDiskExecutor(spec, part, sparse_store, dense_store, region,
                                          capacity=capacity, scatter=scatter,
                                          retry=self.io_retry, obs=rec)
        cfg = StepConfig(strategy="hybrid", n_local=part.n_local, exchange="sparse",
                         capacity=capacity, backend="torch")
        real_mask = self._put(part.global_ids_grid() < self.n)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        meta = {
            "strategy": "hybrid", "theta": theta, "capacity": capacity, "part": part,
            "pm": None, "hm": None, "cfg": cfg, "backend": "torch", "plan": None,
            "residency": "disk", "store": sparse_store, "executor": executor,
            "step": make_disk_step(spec, executor), "device": str(self.device),
            "n_dense": int(np.asarray(region.d_count).sum()),
            "prepare_s": time.perf_counter() - t0,
            "exchange": "sparse",
            "exchange_decision": "hybrid disk: compact sparse-region stream",
            "delta_eps": None,
            "delta_reason": (None if self.delta_eps is None
                             else "residency='disk' keeps the full stream"),
        }
        return sparse_store, real_mask, meta

    def _resolve_disk_exchange(self, spec: GimvSpec, strategy: str, capacity: int | None,
                               plan: planner.ExecutionPlan, part: Partition):
        """Out-of-core counterpart of ``_resolve_exchange``: the per-pair
        index sets come from the store's v2 packed index shards (decoded,
        never the edge shards).  A forced 'packed' against a v1 store raises
        ManifestVersionError; 'auto' then keeps the padded stream and says
        why.  Returns (exchange, xplan, xchg device arrays, decision)."""
        exchange = self.exchange
        if strategy != "vertical" or capacity is None:
            if exchange in ("packed", "auto"):
                exchange = "sparse"
            return exchange, None, None, "n/a"
        if exchange not in ("packed", "auto"):
            return exchange, None, None, "forced"
        if not self.store.has_packed_index:
            if exchange == "packed":
                self.store.require_packed_index()  # raises ManifestVersionError
            return "sparse", None, None, (
                f"auto: store format v{self.store.version} has no packed index shards")
        with self.obs.span("prepare.exchange") as sp:
            xp, arrays = exchange_plan.build_exchange(
                self.store.packed_row_sets(), part.n_local, scatter=plan.scatter)
            sp.set("p_cap", xp.p_cap)
            sp.set("id_bytes", xp.id_bytes)
        decision = "forced"
        if exchange == "auto":
            use_packed = cost_model.prefer_packed_exchange(
                self.b, capacity, xp.payload_slots, xp.id_bytes, None,
                self._wire_itemsize(spec))
            exchange = "packed" if use_packed else "sparse"
            decision = ("auto: packed undercuts padded" if use_packed
                        else "auto: padded stream kept")
        if exchange != "packed":
            return exchange, None, None, decision
        return exchange, xp, {k: self._put(a) for k, a in arrays.items()}, decision

    def explain(self, spec: GimvSpec, ctx: dict | None = None, *,
                live: bool = False, live_iters: int = 3) -> str:
        """Human-readable report of the prepared ExecutionPlan: per-block
        tactic, nnz, max in-degree, padding occupancy and predicted cost,
        plus plan-level aggregates and the exchange section.  Prepares (and
        caches) the solve as a side effect.

        ``live=True`` additionally runs a short traced probe solve
        (``live_iters`` iterations, convergence disabled) with a temporary
        recorder swapped onto the engine (and the disk executor and store
        when out of core) and appends measured-vs-predicted timings,
        per-iteration wall / exchange series and I/O overlap.  The engine's,
        executor's and store's own recorders are restored afterwards."""
        meta = self.prepare(spec, ctx)[-1]
        extra = {"spec": spec.name, "exchange": meta.get("exchange", self.exchange)}
        if meta["hm"] is not None:
            extra["dense_region_vertices"] = meta["n_dense"]
        if meta["plan"] is None:
            # hybrid out of core bypasses the planner: nothing tactic-shaped
            # to format, but the report still gives the shape
            text = ("hybrid out-of-core: structural schedule over the "
                    "θ-split shards (sparse_vertical + dense_horizontal)\n"
                    f"  theta={meta['theta']}  capacity={meta['capacity']}"
                    f"  dense_region_vertices={meta['n_dense']}")
        else:
            text = planner.format_plan(meta["plan"], extra=extra)
        xsec = self._format_exchange_section(spec, meta)
        if xsec:
            text = text + "\n" + xsec
        if not live:
            return text
        from repro_torch.obs.recorder import Recorder
        from repro_torch.obs.report import format_live_report

        probe = Recorder()
        targets = [self]
        if meta["residency"] == "disk":
            targets += [meta["executor"], meta["store"]]
        saved = [(t, t.obs) for t in targets]
        try:
            for t in targets:
                t.obs = probe
            # tol=0.0 never converges: the probe runs exactly live_iters;
            # no overflow fallback, so it reports the configured path
            self.run(spec, ctx, max_iters=live_iters, tol=0.0, _allow_fallback=False)
        finally:
            for t, o in saved:
                t.obs = o
        return text + "\n" + format_live_report(probe, plan=meta["plan"])

    def _format_exchange_section(self, spec: GimvSpec, meta) -> str | None:
        """The explain() exchange section (per-pair index-set sizes, packed
        bit widths, predicted bytes/iter under both transports, and the
        prefer_packed_exchange decision).  When the packed arrays were not
        built (sparse / dense modes), the byte model is estimated from the
        structural partial-nnz template so the comparison still renders."""
        if meta["strategy"] == "horizontal" or meta["capacity"] is None:
            return None
        cfg = meta["cfg"]
        xp = cfg.xplan
        estimated = False
        if xp is None:
            pm, hm = meta.get("pm"), meta.get("hm")
            if meta["strategy"] == "vertical" and pm is not None:
                nnz = pm.partial_nnz
            elif hm is not None:
                nnz = hm.sparse_partial_nnz
            else:
                return None
            xp = exchange_plan.summarize_row_sizes(
                exchange_plan.row_sets_from_nnz_template(np.asarray(nnz)),
                meta["part"].n_local)
            estimated = True
        sec = exchange_plan.format_exchange(
            xp, mode=meta.get("exchange", self.exchange),
            decision=meta.get("exchange_decision", "n/a"),
            capacity=meta["capacity"], itemsize=self._wire_itemsize(spec),
            delta_eps=cfg.delta_eps, estimated=estimated)
        reason = meta.get("delta_reason")
        if self.delta_eps is not None and reason not in (None, "active"):
            sec += f"\n  delta iteration      requested but OFF: {reason}"
        return sec

    # ------------------------------------------------------------------
    def run(
        self,
        spec: GimvSpec,
        ctx: dict | None = None,
        *,
        max_iters: int = 100,
        tol: float = 1e-6,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        v0: np.ndarray | None = None,
        _allow_fallback: bool = True,
    ) -> PMVResult:
        """Iterate to ``tol`` or ``max_iters``.

        ``checkpoint_dir`` with ``checkpoint_every`` = k commits the blocked
        iterate after every k-th iteration (atomically: a temp file, then
        ``os.replace``).  ``resume=True`` starts from the committed iterate
        and iteration when the directory holds one: ``max_iters`` counts
        from iteration 0, and ``per_iter`` holds only the iterations this
        call ran.  A corrupt checkpoint warns (CheckpointCorruptWarning) and
        the solve restarts from the start vector.  As in the JAX package the
        delta-iteration state is not checkpointed: a resumed run restarts
        it at the identity.

        ``v0`` (a global [n] vector) starts the solve in place of
        ``spec.init``.  The JAX package has no such argument: it exists for
        parity checks, so that a query served by ``PMVServer`` can be solved
        alone on the same prepared spec (``PMVServer.engine_for``) without a
        second prepare, a spec's static prepare being cached per spec object.
        A checkpoint that ``resume`` loads wins over ``v0``, which then
        starts only a solve that finds no usable checkpoint.

        An overflow of a model capacity retries the run once on
        ``fallback_overrides``' configuration (from the start vector, not
        from a checkpoint) and records it in ``totals['fallback']`` and the
        ``pmv.fallbacks`` / ``pmv.fallback_events.<label>`` counters; with
        ``_allow_fallback=False``, or where no fallback exists, it raises.

        Under a mesh every rank calls ``run`` with the same arguments; each
        returns the whole vector and the same per-iteration stats (the
        delta and the counts summed over the workers).  A checkpoint is
        gathered onto every rank, written by worker 0 alone, and waited for
        by every rank before the solve goes on."""
        matrix, v, ctx_b, mask, meta = self.prepare(spec, ctx)
        part: Partition = meta["part"]
        cfg: StepConfig = meta["cfg"]
        disk_step = meta.get("step")
        axis = self.axis
        step = self.on_device(lambda m, *args: placement_call(spec, cfg, m, *args, axis=axis))
        if v0 is not None:
            v = self._put(self.own_rows(part.to_blocked(np.asarray(v0, dtype=spec.dtype))))
        # delta-iteration carried state: the previously shipped packed
        # payload on the wire, initialized to the combineAll identity (a
        # suppressed row then delivers the identity, a no-op, until it first
        # moves)
        xstate = None
        if cfg.delta_eps is not None:
            xstate = torch.full((len(self.own_rows(range(self.b))), self.b, cfg.xplan.p_dev),
                                spec.identity,
                                dtype=_wire_dtype(cfg.payload_dtype) or spec.torch_dtype,
                                device=self.device)

        start_iter = 0
        if resume and checkpoint_dir and os.path.exists(_ckpt_path(checkpoint_dir)):
            try:
                v_np, start_iter = _ckpt_load(checkpoint_dir)
            except CheckpointCorruptError as e:
                # _ckpt_save commits atomically, so a corrupt file is an
                # external fault: restart from the start vector
                warnings.warn(f"ignoring corrupt checkpoint: {e}",
                              CheckpointCorruptWarning, stacklevel=2)
                start_iter = 0
            else:
                v = self._put(self.own_rows(v_np))

        per_iter: list[dict] = []
        converged = False
        it = start_iter
        obs = self.obs
        for it in range(start_iter, max_iters):
            if self._fault_injector is not None:
                # a kill fires HERE, before any work of the iteration, so a
                # checkpointed run dies at a clean boundary and resume=True
                # replays from the last commit bitwise
                self._fault_injector.on_iteration(it)
            t0 = time.perf_counter()
            with obs.span("pmv.iteration") as sp:
                if disk_step is not None:
                    v_new, _r, stats = disk_step(matrix, v, ctx_b, mask)
                elif xstate is not None:
                    v_new, _r, stats, xstate = step(matrix, v, ctx_b, mask, xstate)
                else:
                    v_new, _r, stats = step(matrix, v, ctx_b, mask)
                delta = collectives.psum(spec.default_delta(v, v_new), axis)
                keys = [k for k, x in stats.items() if isinstance(x, torch.Tensor)]
                scalars = torch.stack([delta.to(torch.float32)]
                                      + [stats[k].to(torch.float32) for k in keys])
                # the fence makes the span cover the device work, not just
                # the launches.  It waits once the delta's launches are
                # queued, so they still overlap the step on the device
                # (fencing before them cost 8% of an SSSP iteration on the
                # H100).  The null recorder's fence is the identity.
                v_new = obs.fence(v_new)
                # one device->host copy per iteration for every scalar the
                # iteration produced (it also waits for the iteration to finish)
                vals = scalars.tolist()
                delta = vals[0]
                sp.set("iteration", it)
                sp.set("delta", delta)
            wall = time.perf_counter() - t0
            rec = {k: float(x) for k, x in stats.items() if not isinstance(x, torch.Tensor)}
            rec.update(zip(keys, vals[1:]))
            rec.update(delta=delta, wall_s=wall, iteration=it)
            rec["io_elems"] = self._paper_io(meta, rec)
            per_iter.append(rec)
            if obs.enabled:
                self._record_iteration(obs, meta, rec, it - start_iter + 1)
            v = v_new
            if rec.get("overflow", 0.0) > 0:
                fb = self.fallback_overrides(meta["strategy"]) if _allow_fallback else None
                if fb is not None:
                    label, overrides = fb
                    obs.counter("pmv.fallbacks").add(1)
                    obs.counter(f"pmv.fallback_events.{label}").add(1)
                    fallback = self._fallback_engine(meta, overrides)
                    try:
                        result = fallback.run(
                            spec, ctx, max_iters=max_iters, tol=tol,
                            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                            resume=False, v0=v0, _allow_fallback=False)
                    finally:
                        # out of core: stop the retry's prefetch threads
                        for *_, m in fallback._prep_cache.values():
                            if m.get("executor") is not None:
                                m["executor"].close()
                    result.totals["fallback"] = label
                    return result
                raise RuntimeError(
                    f"sparse exchange overflow: capacity {meta['capacity']} too small -- "
                    "rerun with capacity='structural' or exchange='dense'")
            if checkpoint_dir and checkpoint_every and (it + 1) % checkpoint_every == 0:
                v_all = collectives.all_gather(v, axis).cpu().numpy()
                if collectives.axis_index(axis) == 0:
                    _ckpt_save(checkpoint_dir, v_all, it + 1)
                collectives.barrier(axis)
            if delta < tol:
                converged = True
                it += 1
                break
        else:
            it = max_iters

        v_np = part.from_blocked(collectives.all_gather(v, axis).cpu().numpy())
        totals = {
            "physical_elems": sum(r.get("gathered_elems", 0.0) + r.get("exchanged_elems", 0.0)
                                  for r in per_iter),
            "logical_elems": sum(r.get("logical_elems", 0.0) for r in per_iter),
            "wall_s": sum(r["wall_s"] for r in per_iter),
            "exchanged_bytes": sum(r.get("exchanged_bytes", 0.0) for r in per_iter),
            "gathered_bytes": sum(r.get("gathered_bytes", 0.0) for r in per_iter),
        }
        if per_iter and "exchange_id_bytes" in per_iter[0]:
            # the packed transport ships its ids ONCE (at prepare), so the
            # total counts them once; the padded stream re-ships its int32
            # ids every iteration
            totals["exchange_id_bytes"] = (
                per_iter[0]["exchange_id_bytes"] if meta["exchange"] == "packed"
                else sum(r["exchange_id_bytes"] for r in per_iter))
            totals["exchange_payload_bytes"] = sum(r["exchange_payload_bytes"] for r in per_iter)
            totals["wire_bytes"] = totals["exchange_id_bytes"] + totals["exchange_payload_bytes"]
        if per_iter and "delta_sent_rows" in per_iter[0]:
            totals["delta_sent_rows"] = sum(r["delta_sent_rows"] for r in per_iter)
            totals["delta_suppressed_rows"] = sum(r["delta_suppressed_rows"] for r in per_iter)
        totals.update(self._io_totals(per_iter))
        return PMVResult(v=v_np, iterations=it, converged=converged,
                         strategy=meta["strategy"], theta=meta["theta"],
                         capacity=meta["capacity"], per_iter=per_iter, totals=totals)

    @staticmethod
    def _record_iteration(obs, meta: dict, rec: dict, iters_so_far: int) -> None:
        """The per-iteration counter and series of the JAX package's run
        loop (the out-of-core SPMD per-worker ``.w{k}`` series are not
        ported);
        ``iters_so_far`` counts this call's iterations, this one included."""
        obs.counter("pmv.iterations").add(1)
        obs.series("pmv.delta").append(rec["delta"])
        obs.series("pmv.iter_wall_s").append(rec["wall_s"])
        obs.series("pmv.exchanged_bytes").append(rec.get("exchanged_bytes", 0.0))
        obs.series("pmv.gathered_bytes").append(rec.get("gathered_bytes", 0.0))
        if "exchange_payload_bytes" in rec:
            obs.series("pmv.exchange_payload_bytes").append(rec["exchange_payload_bytes"])
            # the packed transport ships its ids once: the amortized leg
            # decays 1/iters; the padded stream re-pays it whole
            id_b = rec.get("exchange_id_bytes", 0.0)
            obs.series("pmv.exchange_id_bytes_amortized").append(
                id_b / iters_so_far if meta.get("exchange") == "packed" else id_b)
        if "delta_sent_rows" in rec:
            obs.series("pmv.delta_sent_rows").append(rec["delta_sent_rows"])
            obs.series("pmv.delta_suppressed_rows").append(rec["delta_suppressed_rows"])
        if "store_bytes_read" in rec:  # disk residency: per-iteration I/O
            obs.series("pmv.io_bytes").append(rec["store_bytes_read"])
            obs.series("pmv.io_overlap").append(rec["store_overlap"])

    def on_device(self, step):
        """``step(matrix, ...)`` reading the prepared matrix where it runs:
        under residency='host' on the GPU the pinned matrix is copied to the
        card inside each call (and freed when it returns); otherwise
        ``step`` itself."""
        if not (self.residency == "host" and self.device.type == "cuda"):
            return step

        def copied(matrix, *args):
            return step(_tree_map(lambda t: t.to(self.device, non_blocking=True), matrix),
                        *args)

        return copied

    def fallback_overrides(self, strategy: str) -> tuple[str, dict] | None:
        """Overflow recovery: the model capacity truncated a partial, so the
        run is retried once on an overflow-free configuration -- vertical:
        the dense exchange (out of core, where only the compact exchange
        streams: the structural capacity); hybrid: the structural capacity
        (its compact exchange has no dense form).  (label, engine overrides)
        or None.  PMVServer requeues an overflowing batch with the same
        table."""
        if strategy == "vertical" and self.residency == "disk":
            if self.capacity_mode != "structural":
                return "structural_capacity", {"capacity": "structural"}
            return None
        if strategy == "vertical" and self.exchange != "dense":
            return "dense", {"exchange": "dense"}
        if strategy == "hybrid" and self.capacity_mode != "structural":
            return "structural_capacity", {"capacity": "structural"}
        return None

    def _fallback_engine(self, meta, overrides: dict) -> "PMVEngine":
        """An engine like this one with ``overrides`` applied, sharing its
        recorder and fault injector."""
        kwargs = dict(
            strategy=meta["strategy"], theta=meta["theta"], psi=self.psi,
            exchange=self.exchange, capacity=self.capacity_mode, slack=self.slack,
            payload_dtype=self.payload_dtype, delta_eps=self.delta_eps, backend=self.backend,
            scatter=self.scatter, stream=self.stream, base_weights=self.base_weights,
            obs=self.obs, faults=self._fault_injector, io_retry=self.io_retry,
            mesh=self.mesh, axis_name=self.axis_name, device=self.device)
        kwargs.update(overrides)
        if self.store is not None:
            return PMVEngine(None, store=self.store, residency=self.residency,
                             store_budget_bytes=self.store_budget_bytes, **kwargs)
        # the edges were symmetrized in __init__ if asked
        return PMVEngine(self.edges, self.n, b=self.b, **kwargs)

    _IO_TOTAL_KEYS = ("store_bytes_read", "store_blocks_fetched", "store_blocks_skipped",
                      "store_io_s", "store_wait_s", "store_compute_s", "store_read_s",
                      "store_verify_s", "store_weights_s", "store_h2d_s")

    @classmethod
    def _io_totals(cls, per_iter: list[dict]) -> dict:
        """The disk-I/O leg of ``PMVResult.totals``: the disk executor's
        per-iteration store_* stats summed over the run, and the same keys
        zeroed (overlap 1.0, nothing to hide) for resident runs."""
        totals = {k: sum(r.get(k, 0.0) for r in per_iter) for k in cls._IO_TOTAL_KEYS}
        io_s, wait_s = totals["store_io_s"], totals["store_wait_s"]
        totals["store_overlap"] = max(0.0, 1.0 - wait_s / io_s) if io_s > 0.0 else 1.0
        return totals

    def _paper_io(self, meta, rec) -> float:
        """Per-iteration I/O in vector elements, the paper's metric:
        horizontal: (b+1)|v| (Lemma 3.1);
        vertical:   2|v| + 2 Σ|v^(i,j)|_nonzero (Lemma 3.2, measured);
        hybrid:     |v|P_out + b|v_d| + |v| + 2 Σ|v_s^(i,j)| (Lemma 3.3)."""
        n, b = self.n, self.b
        logical = rec.get("logical_elems", 0.0)
        if meta["strategy"] == "horizontal":
            return (b + 1.0) * n
        if meta["strategy"] == "vertical":
            return 2.0 * n + 2.0 * logical
        n_dense = meta["n_dense"]
        p_out = 1.0 - n_dense / n
        return n * p_out + b * n_dense + n + 2.0 * logical


def _tree_map(fn, obj: Any):
    """Apply ``fn`` to every tensor of a prepared matrix: dicts, lists and
    tuples, and the frozen dataclasses of core.blocks / core.placement."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, x) for k, x in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, x) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _tree_map(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


# ---------------------------------------------------------------------------
# Checkpoints: the JAX package's pmv_state.npz, written and read alike.

class CheckpointCorruptError(RuntimeError):
    """The resume state on disk is unreadable (truncated, not an npz)."""


class CheckpointCorruptWarning(UserWarning):
    """A corrupt checkpoint was ignored: the solve restarted from its start."""


def _ckpt_path(d: str) -> str:
    return os.path.join(d, "pmv_state.npz")


def _ckpt_save(d: str, v: np.ndarray, it: int) -> None:
    """Atomic checkpoint commit: the whole npz goes to a temp file that
    ``os.replace`` moves over the live one, so a crash mid-write leaves the
    previous complete checkpoint or the new one, never a truncated file."""
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, "pmv_state.tmp.npz")
    np.savez(tmp, v=v, it=it)
    os.replace(tmp, _ckpt_path(d))


def _ckpt_load(d: str) -> tuple[np.ndarray, int]:
    import zipfile

    path = _ckpt_path(d)
    try:
        with np.load(path) as z:
            return z["v"], int(z["it"])
    except (zipfile.BadZipFile, ValueError, EOFError, OSError, KeyError) as e:
        raise CheckpointCorruptError(f"{path}: {e}") from e
