"""Run the port's SPMD path on W gloo ranks on the CPU (no JAX here: the
ranks import only torch, numpy and repro_torch).

``spawn(task, world, payload)`` starts W processes, each running
``TASKS[task](payload)`` as one rank of a gloo group that meets on a
``file://`` store in a fresh temporary directory (no TCP port to race for
under pytest-xdist), with one torch thread per rank.  ``Spawned.results()``
waits for them under a hard timeout (a hung collective fails its test, it
does not eat the suite's clock) and returns each rank's return value.  The
parent test computes its references while the ranks run.

Every task builds the DeviceMesh it is given (``payload['mesh']``: the mesh
shape and dim names, and optionally the ranks' order) after
``init_process_group``; engines run with
``device='cpu'`` (``engine_cases`` takes ``payload['device']``: with 'cuda'
every rank runs its kernels on ``cuda:{LOCAL_RANK % device_count()}``, and
gloo moves the card's tensors).
"""
from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120.0


class Spawned:
    """W rank processes of one task; ``results()`` collects them."""

    def __init__(self, task: str, world: int, payload, timeout: float):
        self.world, self.timeout = world, timeout
        self.dir = tempfile.mkdtemp(prefix="spmd_")
        with open(os.path.join(self.dir, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT / "src"), str(ROOT / "tests"), os.environ.get("PYTHONPATH", "")]),
            "WORLD_SIZE": str(world), "SPMD_DIR": self.dir, "SPMD_TASK": task,
            "OMP_NUM_THREADS": "1"}
        self.procs = []
        for rank in range(world):
            log = open(os.path.join(self.dir, f"r{rank}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, "-c", "from _torch_spmd import rank_main; rank_main()"],
                env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}, cwd=str(ROOT),
                stdout=log, stderr=subprocess.STDOUT), log))
        self.t0 = time.monotonic()

    def results(self) -> list:
        try:
            for proc, _ in self.procs:
                left = max(1.0, self.timeout - (time.monotonic() - self.t0))
                try:
                    proc.wait(timeout=left)
                except subprocess.TimeoutExpired:
                    raise AssertionError(
                        f"SPMD ranks still running after {self.timeout:.0f} s\n" + self._logs())
            for rank, (proc, _) in enumerate(self.procs):
                if proc.returncode != 0:
                    raise AssertionError(f"rank {rank} exited {proc.returncode}\n" + self._logs())
            out = []
            for rank in range(self.world):
                with open(os.path.join(self.dir, f"r{rank}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for proc, log in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
            shutil.rmtree(self.dir, ignore_errors=True)

    def _logs(self) -> str:
        parts = []
        for rank in range(self.world):
            text = Path(self.dir, f"r{rank}.log").read_text(errors="replace")
            if text.strip():
                parts.append(f"--- rank {rank} ---\n{text[-3000:]}")
        return "\n".join(parts)


def spawn(task: str, world: int, payload, timeout: float = TIMEOUT_S) -> Spawned:
    return Spawned(task, world, payload, timeout)


def run(task: str, world: int, payload, timeout: float = TIMEOUT_S) -> list:
    return spawn(task, world, payload, timeout).results()


def rank_main() -> None:
    """Entry point of one rank (a subprocess of :func:`spawn`).  After its
    result is written it waits for every rank and leaves with ``os._exit``:
    tearing the gloo groups down while a peer's connections close can abort
    the process in C++ ("terminate called without an active exception")."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    d = os.environ["SPMD_DIR"]
    code = 1
    try:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                                world_size=world)
        with open(os.path.join(d, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        name = os.environ["SPMD_TASK"]
        if ":" in name:     # 'module:function' of a sibling helper (tests/_torch_mesh.py)
            import importlib

            mod, fn = name.split(":")
            task = getattr(importlib.import_module(mod), fn)
        else:
            task = TASKS[name]
        out = task(payload)
        with open(os.path.join(d, f"r{rank}.tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(d, f"r{rank}.tmp"), os.path.join(d, f"r{rank}.pkl"))
        dist.barrier()
        code = 0
    except BaseException:  # noqa: BLE001 -- reported through the rank's log and exit code
        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


# ---------------------------------------------------------------------------
# Tasks: each runs on every rank and returns a picklable value.
# ---------------------------------------------------------------------------

def make_mesh(shape, names, order=None):
    """A DeviceMesh of ``shape`` with dim names ``names``, its ranks in
    row-major ``order`` (default ascending)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(int(np.prod(shape))) if order is None else torch.tensor(order)
    return DeviceMesh("cpu", ranks.reshape(tuple(shape)), mesh_dim_names=tuple(names))


# algorithm -> (spec factory(module, n), ctx factory | None, symmetrize)
def _algo(name, n):
    import repro_torch.core as T

    if name == "pagerank":
        return T.pagerank(n), None, False
    if name == "rwr":
        return T.random_walk_with_restart(n, 1), T.rwr_context(n, 1), False
    if name == "sssp":
        return T.sssp(0), None, False
    if name == "cc":
        return T.connected_components(), None, True
    raise ValueError(name)


def _result(r) -> dict:
    return {"v": r.v, "iterations": r.iterations, "converged": r.converged,
            "per_iter": [{k: x for k, x in rec.items() if k != "wall_s"} for rec in r.per_iter]}


def engine_cases(payload) -> list:
    """Each case of ``payload['cases']`` (engine knobs plus 'algo' and
    'run', and optionally 'mesh' / 'axis_name' / 'b' in place of the
    payload's) through ``PMVEngine(mesh=...)``; returns one ``_result``
    each."""
    import repro_torch.core as T

    meshes = {}
    edges, n = payload["edges"], payload["n"]
    out = []
    for case in payload["cases"]:
        kw = dict(case)
        algo, run_kw = kw.pop("algo"), kw.pop("run")
        b = kw.pop("b", payload["b"])
        shape = kw.pop("mesh", payload.get("mesh"))
        axis_name = kw.pop("axis_name", payload.get("axis_name"))
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        spec, ctx, sym = _algo(algo, n)
        eng = T.PMVEngine(edges, n, b=b, symmetrize=sym, mesh=meshes[shape],
                          axis_name=axis_name, device=payload.get("device", "cpu"), **kw)
        r = eng.run(spec, ctx, **run_kw)
        res = _result(r)
        if eng.obs.enabled:         # this rank's own recorder
            res["obs"] = {"iterations": eng.obs.counter("pmv.iterations").value,
                          "spans": [e["name"] for e in eng.obs.spans("pmv.")],
                          "exchanged_bytes": eng.obs.series("pmv.exchanged_bytes").values}
        res["meta"] = {k: eng.prepare(spec, ctx)[-1][k] for k in ("exchange", "backend")}
        res["meta"]["stream"] = eng.prepare(spec, ctx)[-1]["plan"].stream
        out.append(res)
    return out


def batched_hier(payload) -> dict:
    """One batched step (``make_batched_step``) of PageRank on a hier and a
    flat sparse engine over the same mesh, from the same random [b, n_local,
    Q] batch, for each backend of ``payload['backends']``; returns each's
    gathered v_new, deltas and stats by (backend, 'hier' | 'flat')."""
    import torch

    import repro_torch.core as T
    from repro_torch.core import collectives
    from repro_torch.serving import make_batched_step

    mesh = make_mesh(*payload["mesh"])
    axis_name = payload["axis_name"]
    edges, n, b, q = payload["edges"], payload["n"], payload["b"], payload["q"]
    out = {}
    for backend in payload["backends"]:
        for name, exchange in (("hier", "hier"), ("flat", "sparse")):
            eng = T.PMVEngine(edges, n, b=b, strategy="vertical", exchange=exchange, mesh=mesh,
                              axis_name=axis_name, backend=backend, device="cpu")
            spec = T.pagerank(n)
            matrix, _v0, _ctx, mask, meta = eng.prepare(spec)
            step = make_batched_step(spec, meta["cfg"], mesh, axis_name, delta_kind="abs")
            v = torch.from_numpy(eng.own_rows(payload["v"]).copy())
            v_new, deltas, st = step(matrix, v, {}, mask, torch.ones(q, dtype=torch.bool))
            out[backend, name] = {"v": collectives.all_gather(v_new, eng.axis).numpy(),
                                  "deltas": deltas.numpy(),
                                  "stats": {k: float(x) for k, x in st.items()}}
    return out


def serve(payload) -> list:
    """``PMVServer(mesh=...).serve`` of ``payload['queries']`` ((kind,
    source, tol) triples); returns each answer's vector and iterations."""
    from repro_torch.serving import PMVServer, Query

    mesh = make_mesh(*payload["mesh"])
    srv = PMVServer(payload["edges"], payload["n"], b=payload["b"], mesh=mesh,
                    axis_name=payload["axis_name"], device="cpu", **payload["server"])
    try:
        res = srv.serve([Query(k, source=s, tol=t) for k, s, t in payload["queries"]])
    finally:
        srv.close()
    return [(r.vector, r.iterations, r.converged, r.reason) for r in res]


def checkpoint(payload) -> dict:
    """A clean SPMD solve, then the same solve killed before iteration
    ``kill_at`` with a checkpoint every iteration and resumed from it."""
    import repro_torch.core as T
    from repro_torch.faults import FaultPlan, InjectedKill, KillAtIteration

    mesh = make_mesh(*payload["mesh"])
    edges, n, b = payload["edges"], payload["n"], payload["b"]
    spec, ctx, sym = _algo(payload["algo"], n)
    kw = dict(b=b, symmetrize=sym, mesh=mesh, axis_name=payload["axis_name"], device="cpu",
              **payload["engine"])
    run_kw = payload["run"]
    clean = T.PMVEngine(edges, n, **kw).run(spec, ctx, **run_kw)
    eng = T.PMVEngine(edges, n, faults=FaultPlan(events=(KillAtIteration(payload["kill_at"]),)),
                      **kw)
    d = payload["dir"]
    killed = False
    try:
        eng.run(spec, ctx, checkpoint_dir=d, checkpoint_every=1, **run_kw)
    except InjectedKill:
        killed = True
    with __import__("numpy").load(os.path.join(d, "pmv_state.npz")) as z:
        saved = {"v": z["v"].copy(), "it": int(z["it"])}
    resumed = eng.run(spec, ctx, checkpoint_dir=d, checkpoint_every=1, resume=True, **run_kw)
    return {"clean": _result(clean), "resumed": _result(resumed), "killed": killed,
            "saved": saved}


def make_step_cases(payload) -> list:
    """``repro_torch.core.make_step`` under a mesh, one step of each case of
    ``payload['make_step']`` (engine knobs of a PageRank engine plus 'mesh',
    'axis_name', 'v' the blocked start vector and optionally 'b') from its
    'v' (and, with delta iteration, a zero state): the gathered v_new, the
    delta, the stats and the gathered new state."""
    import torch

    import repro_torch.core as T
    from repro_torch.core import collectives

    out = []
    edges, n, b = payload["edges"], payload["n"], payload["b"]
    for case in payload["make_step"]:
        kw = dict(case)
        mesh_shape, axis_name = kw.pop("mesh"), kw.pop("axis_name")
        b, v_blocked = kw.pop("b", b), kw.pop("v")
        mesh = make_mesh(*mesh_shape)
        eng = T.PMVEngine(edges, n, b=b, mesh=mesh, axis_name=axis_name, device="cpu", **kw)
        spec = T.pagerank(n)
        matrix, _v0, _ctx, mask, meta = eng.prepare(spec)
        cfg = meta["cfg"]
        step = T.make_step(spec, cfg, mesh, axis_name)
        v = torch.from_numpy(eng.own_rows(v_blocked).copy())
        extra = ()
        if cfg.delta_eps is not None:
            extra = (torch.zeros((1, b, cfg.xplan.p_dev), dtype=torch.float32),)
        got = step(matrix, v, {}, mask, *extra)
        res = {"v": collectives.all_gather(got[0], eng.axis).numpy(), "delta": float(got[1]),
               "stats": {k: float(x) for k, x in got[2].items()}}
        if extra:
            res["state"] = collectives.all_gather(got[3], eng.axis).numpy()
        out.append(res)
    return out


def axis_rows(payload) -> list:
    """For each (mesh, axis_name) of ``payload['axes']``: this rank's
    ``WorkerAxis`` (index, replica, ranks, order) and its ``all_gather``,
    ``all_to_all`` and ``all_gather_object`` of its row of a [b, b, 3] array
    every rank draws from the same seed (b the axis size)."""
    import torch

    from repro_torch.core import collectives

    out = []
    for shape, axis_name in payload["axes"]:
        axis = collectives.worker_axis(make_mesh(*shape), axis_name)
        x = np.random.default_rng(axis.size).standard_normal(
            (axis.size, axis.size, 3)).astype(np.float32)
        mine = torch.from_numpy(x[axis.index:axis.index + 1].copy())
        out.append({"index": axis.index, "replica": axis.replica, "ranks": axis.ranks,
                    "order": axis.order,
                    "all_gather": collectives.all_gather(mine, axis).numpy(),
                    "all_to_all": collectives.all_to_all(mine, axis).numpy(),
                    "objects": collectives.all_gather_object(axis.index, axis)})
    return out


def barrier_waits(payload) -> list:
    """For each (mesh, axis_name) of ``payload['barriers']``: the seconds
    this rank spent in ``collectives.barrier`` of that axis while rank 0
    slept ``payload['sleep_s']`` before entering it (all ranks aligned by a
    default-group barrier first)."""
    import time

    import torch.distributed as dist

    from repro_torch.core import collectives

    out = []
    for shape, axis_name in payload["barriers"]:
        axis = collectives.worker_axis(make_mesh(*shape), axis_name)
        dist.barrier()
        if dist.get_rank() == 0:
            time.sleep(payload["sleep_s"])
        t0 = time.perf_counter()
        collectives.barrier(axis)
        out.append(time.perf_counter() - t0)
    return out


def mesh_cases(payload) -> dict:
    """One spawn's seven parts: the refusals (:func:`refusals`), the worker
    axes of meshes with a dim outside axis_name or ranks against worker
    order (:func:`axis_rows`), the engine cases of ``payload['cases']``
    (:func:`engine_cases`: such meshes, backend 'pallas'), the make_step
    cases (:func:`make_step_cases`), a serve on such a mesh (:func:`serve`
    of ``payload['serve']``), a kill and resume on such a mesh
    (:func:`checkpoint` of ``payload['checkpoint']``) and the mesh-wide
    barrier's waits (:func:`barrier_waits`)."""
    return {"refusals": refusals(payload), "axes": axis_rows(payload),
            "engine": engine_cases(payload), "make_step": make_step_cases(payload),
            "serve": serve(payload["serve"]), "checkpoint": checkpoint(payload["checkpoint"]),
            "barrier": barrier_waits(payload)}


def refusals(payload) -> dict:
    """The exception (class name, message) each refused configuration
    raises under a mesh (``payload['mesh']``, or the case's own)."""
    import repro_torch.core as T
    from repro_torch.serving import PMVServer

    meshes = {}
    out = {}
    for name, cls, kw in payload["refusals"]:
        ctor = T.PMVEngine if cls == "engine" else PMVServer
        kw = dict(kw)
        shape = kw.pop("mesh", payload["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        try:
            ctor(kw.pop("edges", None), kw.pop("n", None), mesh=meshes[shape], device="cpu",
                 **kw)
        except Exception as e:  # noqa: BLE001 -- the class is what is compared
            out[name] = (type(e).__name__, str(e))
        else:
            out[name] = ("ok", "")
    return out


def _fault_plan(events):
    """A FaultPlan from ``events``: (event class name, its keyword args)."""
    from repro_torch import faults as F

    if not events:
        return None
    return F.FaultPlan(events=tuple(getattr(F, kind)(**kw) for kind, kw in events), seed=0)


FAULT_COUNTERS = ("fault.injected", "fault.injected.transient_io",
                  "fault.injected.corrupt_fetch", "store.verify_failures")


def _disk_engine(case: dict, meshes: dict, device: str):
    """``PMVEngine(None, store=..., residency='disk', mesh=...)`` of a disk
    case (engine knobs plus 'store', 'mesh', and 'faults' as
    :func:`_fault_plan` takes them)."""
    import repro_torch.core as T

    kw = dict(case)
    shape = kw.pop("mesh")
    if shape not in meshes:
        meshes[shape] = make_mesh(*shape)
    plan = _fault_plan(kw.pop("faults", ()))
    return T.PMVEngine(None, residency="disk", mesh=meshes[shape], device=device, faults=plan,
                       **kw)


def _rank_io(meta) -> dict:
    """This rank's own worker stores, leg by leg: (peak resident bytes,
    budget, prefetch degraded)."""
    return {leg.store.striping: (leg.store.local.peak_resident_bytes, leg.store.budget_bytes,
                                 leg.store.local.prefetch_degraded)
            for leg in meta["executor"].legs}


def disk_cases(payload) -> list:
    """Each case of ``payload['cases']`` ({'engine': disk engine knobs, see
    :func:`_disk_engine`; 'algo'; 'run'; 'extras': names}) through the SPMD
    disk engine; returns one ``_result`` each, plus this rank's
    ``_rank_io``.  Extras: 'obs' (the store.prefetch_degraded count and the
    pmv.io_*.w{k} series of this rank's recorder), 'faults' (this rank's
    ``fault.injected*`` and ``store.verify_failures`` counts), 'trace' (the merged
    fleet trace, validated here), 'fleet' (``fleet_report`` of the result),
    'checkpoint' (the case's engine killed by its plan, resumed from
    ``payload['dir']/<case index>``; the result is the resumed run's).  A
    case with 'raises' returns the exception its engine's construction or
    prepare raises."""
    from repro_torch.obs import (check_span_nesting, fleet_report, merge_traces,
                                 validate_chrome_trace)
    from repro_torch.store import open_store

    meshes = {}
    device = payload.get("device", "cpu")
    out = []
    for ci, case in enumerate(payload["cases"]):
        extras = set(case.get("extras", ()))
        n = open_store(case["engine"]["store"]).n
        spec, ctx, _ = _algo(case["algo"], n)
        if case.get("raises"):
            try:
                _disk_engine(case["engine"], meshes, device).prepare(spec, ctx)
            except Exception as e:  # noqa: BLE001 -- the class is what is compared
                out.append((type(e).__name__, str(e)))
            else:
                out.append(("ok", ""))
            continue
        eng = _disk_engine(case["engine"], meshes, device)
        meta = eng.prepare(spec, ctx)[-1]
        try:
            if "checkpoint" in extras:
                from repro_torch.faults import InjectedKill

                d = os.path.join(payload["dir"], str(ci))
                kw = dict(checkpoint_dir=d, checkpoint_every=1, **case["run"])
                try:
                    eng.run(spec, ctx, **kw)
                    killed = False
                except InjectedKill:
                    killed = True
                r = eng.run(spec, ctx, resume=True, **kw)
            else:
                r = eng.run(spec, ctx, **case["run"])
            res = _result(r)
            res["io"] = _rank_io(meta)
            if "checkpoint" in extras:
                res["killed"] = killed
            if "faults" in extras:
                res["faults"] = {k: eng.obs.counter(k).value for k in FAULT_COUNTERS}
            if "obs" in extras:
                res["degraded"] = eng.obs.counter("store.prefetch_degraded").value
                res["series"] = {d["name"]: d["values"] for d in eng.obs.metrics.to_dicts()
                                 if d["name"].startswith("pmv.io_")}
            if "trace" in extras:
                doc = merge_traces(meta["store"].fleet_recorder())
                validate_chrome_trace(doc)
                check_span_nesting(doc)
                res["trace"] = doc
            if "fleet" in extras:
                rep = fleet_report(r)
                res["fleet"] = {"workers": rep.workers, "iterations": len(rep.iterations),
                                "straggler_workers": rep.straggler_workers,
                                "causes": [x["cause"] for x in rep.stragglers],
                                "skew": rep.skew,
                                "kinds": sorted({x["kind"]
                                                 for x in rep.calibration_launches()}),
                                "text": rep.format()}
            out.append(res)
        finally:
            meta["executor"].close()
    return out


def disk_serve(payload) -> list:
    """``PMVServer(store=..., residency='disk', mesh=...).serve`` of
    ``payload['queries']`` ((kind, source, tol, max_iters) tuples); returns
    each answer's vector, iterations, convergence and reason."""
    from repro_torch.serving import PMVServer, Query

    mesh = make_mesh(*payload["mesh"])
    srv = PMVServer(store=payload["store"], residency="disk", mesh=mesh,
                    device=payload.get("device", "cpu"), **payload["server"])
    try:
        res = srv.serve([Query(k, source=s, tol=t, max_iters=m)
                         for k, s, t, m in payload["queries"]])
    finally:
        srv.close()
    return [(r.vector, r.iterations, r.converged, r.reason) for r in res]


def collectives_rows(payload) -> dict:
    """``all_gather`` and ``all_to_all`` of this rank's rows at each b_w of
    ``payload['b_ws']``, on [b, b, k] arrays every rank draws from the same
    seed (b = W * b_w); at b_w = 1 also the resident path's single-row
    exchange (``all_to_all_rows`` of row 0).  Returns this rank's results by
    b_w."""
    import torch

    from repro_torch.core import collectives

    mesh = make_mesh(*payload["mesh"])
    axis = collectives.worker_axis(mesh, "workers")
    out = {}
    for b_w in payload["b_ws"]:
        b = axis.size * b_w
        x = np.random.default_rng(b_w).standard_normal((b, b, 3)).astype(np.float32)
        mine = torch.from_numpy(x[axis.index * b_w:(axis.index + 1) * b_w].copy())
        got = {"all_to_all": collectives.all_to_all(mine, axis).numpy(),
               "all_gather": collectives.all_gather(mine, axis).numpy()}
        if b_w == 1:
            got["rows"] = collectives.all_to_all_rows(mine[0], axis.group)[None].numpy()
        out[b_w] = got
    return out


def disk_group(payload) -> dict:
    """One mesh size's disk cases (:func:`disk_cases`) and, when the payload
    has one, its serve (:func:`disk_serve` of ``payload['serve']``)."""
    out = {"cases": disk_cases(payload)}
    if "serve" in payload:
        out["serve"] = disk_serve(payload["serve"])
    return out


TASKS = {"engine_cases": engine_cases, "batched_hier": batched_hier, "serve": serve,
         "checkpoint": checkpoint, "refusals": refusals, "mesh_cases": mesh_cases,
         "disk_cases": disk_cases, "disk_group": disk_group,
         "collectives_rows": collectives_rows}
