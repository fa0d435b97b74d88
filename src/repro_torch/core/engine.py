"""PMVEngine: pre-partition once, iterate M (x) v to convergence (paper §3.1).

Emulation mode only: all b workers' shards live on one device with an
explicit leading worker axis (placement.py).  The engine runs on the GPU
unless the caller passes ``device='cpu'``, where every kernel wrapper takes
its plain PyTorch version.

Per iteration the engine reports *physical* communicated elements (the
static buffers an exchange would move) and *logical* elements (value-level
non-identity entries, the paper's I/O metric).

``placement_call`` and ``StepConfig`` also serve the multi-query step of
``repro_torch.serving``: v and ctx may carry a trailing query axis.

``exchange='packed'`` derives the per-(source, destination) row sets once at
prepare (``repro_torch.exchange``) and ships only payloads each iteration;
``delta_eps`` then re-sends only the rows that moved, carrying the last
shipped payload from one iteration to the next.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import blocks as blocks_lib
from repro_torch.core import cost_model, placement, planner
from repro_torch.core.gimv import GimvSpec
from repro_torch.core.partition import HybridMatrix, Partition, PartitionedMatrix, partition_graph
from repro_torch.exchange import plan as exchange_plan
from repro_torch.graph.generators import symmetrize_edges
from repro_torch.graph.stats import compute_stats
from repro_torch.kernels.block_gimv import has_semiring, semiring_of

__all__ = ["PMVEngine", "PMVResult", "StepConfig", "placement_call", "resolve_device"]

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


def placement_call(spec: GimvSpec, cfg: StepConfig, matrix: dict, v, ctx, mask,
                   xstate=None):
    """Dispatch one placement step for ``cfg.strategy`` -> (v_new, r, stats),
    plus the new delta-iteration state as a fourth element when ``xstate``
    (the previously shipped packed payload) is passed."""
    scatter = cfg.plan.scatter if cfg.plan is not None else "segment"
    if cfg.strategy == "horizontal":
        return placement.horizontal_step(
            spec, matrix.get("stripe"), v, ctx, mask, n_local=cfg.n_local,
            planned=matrix.get("planned"), backend=cfg.backend)
    if cfg.strategy == "vertical":
        return placement.vertical_step(
            spec, matrix.get("stripe"), v, ctx, mask, n_local=cfg.n_local,
            exchange=cfg.exchange, capacity=cfg.capacity,
            planned=matrix.get("planned"), backend=cfg.backend, scatter=scatter,
            xchg=matrix.get("xchg"), xplan=cfg.xplan, delta_eps=cfg.delta_eps,
            delta_state=xstate)
    if cfg.strategy == "hybrid":
        return placement.hybrid_step(
            spec, matrix.get("sparse_stripe"), matrix.get("dense_stripe"),
            matrix["dense_region"], v, ctx, mask, n_local=cfg.n_local,
            capacity=cfg.capacity, planned_sparse=matrix.get("planned_sparse"),
            dense_matrix=matrix.get("dense_matrix"), backend=cfg.backend,
            scatter=scatter, exchange=cfg.exchange, xchg=matrix.get("xchg"), xplan=cfg.xplan)
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
      'auto' (packed when ``cost_model.prefer_packed_exchange`` says its
      amortized bytes undercut the padded stream's, else sparse).  The
      horizontal placement exchanges no partials: 'packed' / 'auto' resolve
      to 'sparse' there.  meta['exchange'] / ['exchange_decision'] record it.
    delta_eps: delta iteration over the packed exchange: re-send only rows
      that moved more than delta_eps since the last send (0.0: any bitwise
      change, exact).  Active only for a vertical packed solve whose
      combineAll is 'sum' over a float type; meta['delta_reason'] says why
      not otherwise.
    capacity: 'structural' (exact max partial nnz, overflow-free).
    backend: 'torch' (plain tensor ops) | 'auto' (the per-block planner with
      the ELL / dense / scatter-combine kernels).  A spec whose
      (combine2, combineAll) pair has no kernel semiring resolves to 'torch',
      recorded in meta['backend'].
    scatter: receive side of the sparse and packed exchanges -- 'segment' |
      'kernel' | 'auto' (the cost model's crossover).
    stream: 'auto' | 'on' | 'off' (this package runs the materialized
      schedule; a stream that resolves to 'on' raises at prepare: a forced
      'on' resolves to 'off' where nothing streams -- horizontal, the dense
      exchange, backend='torch' -- as in the JAX package).
    device: None (the GPU; raises without one) | 'cuda' | 'cpu'.

    The JAX package's other knobs (mesh, store / residency, exchange='hier',
    capacity='model', payload_dtype, obs, faults, io_retry, checkpointing)
    raise NotImplementedError.
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
        payload_dtype: str | None = None,
        delta_eps: float | None = None,
        backend: str = "torch",
        scatter: str = "auto",
        stream: str = "auto",
        symmetrize: bool = False,
        base_weights: np.ndarray | None = None,
        mesh=None,
        store=None,
        residency: str = "device",
        obs=None,
        faults=None,
        io_retry=None,
        device=None,
    ):
        if mesh is not None:
            raise _not_ported("mesh", "emulation mode only")
        if store is not None:
            raise _not_ported("store")
        if residency != "device":
            raise _not_ported(f"residency={residency!r}")
        if exchange == "hier":
            raise _not_ported(f"exchange={exchange!r}")
        if exchange not in ("sparse", "dense", "packed", "auto"):
            raise ValueError(f"unknown exchange {exchange!r}")
        if capacity != "structural":
            raise _not_ported(f"capacity={capacity!r}")
        if payload_dtype is not None:
            raise _not_ported("payload_dtype")
        if delta_eps is not None and not delta_eps >= 0.0:
            raise ValueError(f"delta_eps must be >= 0, got {delta_eps}")
        if obs:
            raise _not_ported("obs")
        if faults is not None:
            raise _not_ported("faults")
        if io_retry is not None:
            raise _not_ported("io_retry")
        if backend not in BACKENDS:
            if backend in ("pallas", "xla"):
                raise _not_ported(f"backend={backend!r}", "use 'torch' or 'auto'")
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if scatter not in ("auto", "segment", "kernel"):
            raise ValueError(scatter)
        if stream not in ("auto", "on", "off"):
            raise ValueError(stream)
        if edges is None or n is None or b is None:
            raise ValueError("PMVEngine needs (edges, n, b=)")
        self.device = resolve_device(device)
        if symmetrize:
            edges = symmetrize_edges(edges)
        self.edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        self.n = int(n)
        self.b = int(b)
        self.strategy = strategy
        self.theta = theta
        self.psi = psi or "cyclic"
        self.exchange = exchange
        self.delta_eps = delta_eps
        self.backend = backend
        self.scatter = scatter
        self.stream = stream
        self.base_weights = base_weights
        self._prep_cache: dict = {}

    _PREP_CACHE_MAX = 8

    def resolve_strategy(self) -> tuple[str, float | None]:
        m = self.edges.shape[0]
        if self.strategy in ("horizontal", "vertical"):
            return self.strategy, None
        if self.strategy in ("auto", "selective"):
            return cost_model.select_strategy(self.b, self.n, m), None
        if self.strategy == "hybrid":
            if self.theta == "auto":
                theta, _ = cost_model.theta_star(self.b, self.n, compute_stats(self.edges, self.n))
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
        """Only the planned vertical/hybrid compact path has partials to
        stream: the horizontal step never materializes partials, the dense
        exchange ships them whole and the 'torch' backend has no streamed
        form, so there a forced 'on' resolves to 'off', as in the JAX
        package.  Where that package streams a forced 'on' (planned hybrid;
        planned vertical with the sparse, packed or auto exchange) it
        raises: the streamed executor is not ported.  'auto' asks the cost
        model on the hybrid and sparse vertical paths (the streamed packed
        executor is not ported either: packed vertical keeps the fused
        schedule)."""
        streamable = (backend == "planned" and capacity is not None and
                      (strategy == "hybrid" or
                       (strategy == "vertical" and
                        self.exchange in ("sparse", "packed", "auto"))))
        if not streamable or self.stream == "off":
            return "off"
        if self.stream == "on":
            raise _not_ported("stream='on'", f"the JAX package streams this {strategy} "
                              f"solve (exchange={self.exchange!r}); pass stream='off'")
        if ((strategy == "hybrid" or self.exchange == "sparse") and
                cost_model.prefer_streamed(self.b, part.n_local, capacity)):
            raise _not_ported(
                "stream='auto'", f"it resolves to 'on' at b={self.b}, n_local="
                f"{part.n_local}, capacity={capacity}; pass stream='off'")
        return "off"

    def _capacity(self, pm: PartitionedMatrix, hm: HybridMatrix | None) -> int:
        return hm.sparse_partial_cap if hm is not None else pm.partial_cap

    def _put(self, a, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype or t.dtype)

    def _put_stripe(self, stripes: list) -> blocks_lib.BlockEdges:
        s = blocks_lib.stack_stripes(stripes)
        return blocks_lib.BlockEdges(
            seg_local=self._put(s.seg_local, torch.int64),
            gat_local=self._put(s.gat_local, torch.int64),
            w=None if s.w is None else self._put(s.w),
            count=self._put(s.count, torch.int64))

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
        ctx_blocked = {k: self._put(part.to_blocked(np.asarray(x))) for k, x in ctx.items()}
        return matrix, self._put(v0), ctx_blocked, real_mask, meta

    def _prepare_static(self, spec: GimvSpec):
        t0 = time.perf_counter()
        strategy, theta = self.resolve_strategy()
        pm, hm = partition_graph(self.edges, self.n, self.b, spec, psi=self.psi,
                                 base_weights=self.base_weights,
                                 theta=theta if strategy == "hybrid" else None)
        part = pm.part
        nl = part.n_local
        backend = self._resolve_backend(spec)
        matrix: dict = {}
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
                gather_idx=self._put(hm.dense.gather_idx, torch.int64),
                d_count=self._put(hm.dense.d_count), d_cap=hm.dense.d_cap,
                theta=hm.dense.theta)
            if backend == "torch":
                matrix["sparse_stripe"] = self._put_stripe(hm.sparse_vertical)
                matrix["dense_stripe"] = self._put_stripe(hm.dense_horizontal)
            else:
                # the dense REGION is a region-level dense tactic (§3.5):
                # materialized once, one dense kernel launch per iteration.
                semiring = semiring_of(spec.combine2, spec.combine_all)
                dm = np.stack([blocks_lib.materialize_dense_matrix(s, nl, hm.dense.d_cap, semiring)
                               for s in hm.dense_horizontal])
                matrix["dense_matrix"] = self._put(dm.reshape(self.b * nl, -1))
                del dm

        scatter = self.scatter if has_semiring(spec.combine2, spec.combine_all) else "segment"
        stream = self._resolve_stream(strategy, backend, capacity, part)
        plan = planner.plan_execution(
            pm, hm, strategy=strategy, mode=backend, theta=theta, capacity=capacity,
            scatter=scatter, stream=stream, interpret=self.device.type != "cuda")
        if backend == "planned":
            semiring = semiring_of(spec.combine2, spec.combine_all)
            if strategy == "horizontal":
                stripes, layout, key = pm.horizontal, "merged", "planned"
            elif strategy == "vertical":
                stripes, layout, key = pm.vertical, "vertical", "planned"
            else:
                stripes, layout, key = hm.sparse_vertical, "vertical", "planned_sparse"
            packed = blocks_lib.stack_planned([
                blocks_lib.pack_planned_stripe(
                    s, plan.tactics_for_worker(w, layout), nl, layout=layout,
                    boundaries=plan.boundaries, semiring=semiring)
                for w, s in enumerate(stripes)], semiring)
            matrix[key] = placement.flatten_planned(packed, nl, self.b, self.device)
        real_mask = self._put(part.global_ids_grid() < self.n)
        exchange, xplan, delta_eps, xmeta = self._resolve_exchange(
            spec, strategy, capacity, plan,
            pm.vertical if strategy == "vertical" else
            (hm.sparse_vertical if hm is not None else None),
            part, matrix)
        cfg = StepConfig(strategy=strategy, n_local=nl, exchange=exchange,
                         capacity=capacity, backend=backend, plan=plan, xplan=xplan,
                         delta_eps=delta_eps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        meta = {
            "strategy": strategy, "theta": theta, "capacity": capacity, "part": part,
            "pm": pm, "hm": hm, "cfg": cfg, "backend": backend, "plan": plan,
            "device": str(self.device),
            "n_dense": int(hm.dense.d_count.sum()) if hm is not None else 0,
            "prepare_s": time.perf_counter() - t0,
            **xmeta,
        }
        return matrix, real_mask, meta

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
        itemsize = np.dtype(spec.dtype).itemsize
        if exchange in ("packed", "auto"):
            row_sets = exchange_plan.row_sets_from_stripes(stripes, self.b)
            xp, arrays = exchange_plan.build_exchange(row_sets, part.n_local,
                                                      scatter=plan.scatter)
            if exchange == "auto":
                use_packed = cost_model.prefer_packed_exchange(
                    self.b, capacity, xp.payload_slots, xp.id_bytes, None, itemsize)
                exchange = "packed" if use_packed else "sparse"
                decision = ("auto: packed undercuts padded" if use_packed
                            else "auto: padded stream kept")
            if exchange == "packed":
                matrix["xchg"] = {k: self._put(a) for k, a in arrays.items()}
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
            elif not np.issubdtype(np.dtype(spec.dtype), np.floating):
                delta_reason = "integer payloads keep the full stream"
            else:
                delta_eps = float(self.delta_eps)
                delta_reason = "active"
        return exchange, xplan, delta_eps, {
            "exchange": exchange, "exchange_decision": decision,
            "delta_eps": delta_eps, "delta_reason": delta_reason,
        }

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
    ) -> PMVResult:
        """Iterate to ``tol`` or ``max_iters``.

        ``v0`` (a global [n] vector) starts the solve in place of
        ``spec.init``.  The JAX package has no such argument: it exists for
        parity checks, so that a query served by ``PMVServer`` can be solved
        alone on the same prepared spec (``PMVServer.engine_for``) without a
        second prepare, a spec's static prepare being cached per spec object."""
        if checkpoint_dir is not None or checkpoint_every or resume:
            raise _not_ported("checkpoint_dir / checkpoint_every / resume")
        matrix, v, ctx_b, mask, meta = self.prepare(spec, ctx)
        part: Partition = meta["part"]
        cfg: StepConfig = meta["cfg"]
        if v0 is not None:
            v = self._put(part.to_blocked(np.asarray(v0, dtype=spec.dtype)))
        # delta-iteration carried state: the previously shipped packed
        # payload, initialized to the combineAll identity (a suppressed row
        # then delivers the identity, a no-op, until it first moves)
        xstate = None
        if cfg.delta_eps is not None:
            xstate = torch.full((self.b, self.b, cfg.xplan.p_dev), spec.identity,
                                dtype=spec.torch_dtype, device=self.device)

        per_iter: list[dict] = []
        converged = False
        it = 0
        for it in range(max_iters):
            t0 = time.perf_counter()
            if xstate is not None:
                v_new, _r, stats, xstate = placement_call(spec, cfg, matrix, v, ctx_b, mask,
                                                          xstate)
            else:
                v_new, _r, stats = placement_call(spec, cfg, matrix, v, ctx_b, mask)
            delta = spec.default_delta(v, v_new)
            # one device->host copy per iteration for every scalar the
            # iteration produced (it also waits for the iteration to finish)
            keys = [k for k, x in stats.items() if isinstance(x, torch.Tensor)]
            vals = torch.stack([delta.to(torch.float32)]
                               + [stats[k].to(torch.float32) for k in keys]).tolist()
            wall = time.perf_counter() - t0
            rec = {k: float(x) for k, x in stats.items() if not isinstance(x, torch.Tensor)}
            rec.update(zip(keys, vals[1:]))
            delta = vals[0]
            rec.update(delta=delta, wall_s=wall, iteration=it)
            rec["io_elems"] = self._paper_io(meta, rec)
            per_iter.append(rec)
            v = v_new
            if rec.get("overflow", 0.0) > 0:
                raise RuntimeError(
                    f"sparse exchange overflow: capacity {meta['capacity']} too small")
            if delta < tol:
                converged = True
                it += 1
                break
        else:
            it = max_iters

        v_np = part.from_blocked(v.cpu().numpy())
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
        return PMVResult(v=v_np, iterations=it, converged=converged,
                         strategy=meta["strategy"], theta=meta["theta"],
                         capacity=meta["capacity"], per_iter=per_iter, totals=totals)

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
