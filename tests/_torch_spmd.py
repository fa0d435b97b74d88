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
shape and dim names) after ``init_process_group``; engines run with
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
        out = TASKS[os.environ["SPMD_TASK"]](payload)
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

def make_mesh(shape, names):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


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
    'run', and optionally 'mesh' / 'axis_name' in place of the payload's)
    through ``PMVEngine(mesh=...)``; returns one ``_result`` each."""
    import repro_torch.core as T

    meshes = {}
    edges, n, b = payload["edges"], payload["n"], payload["b"]
    out = []
    for case in payload["cases"]:
        kw = dict(case)
        algo, run_kw = kw.pop("algo"), kw.pop("run")
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


def refusals(payload) -> dict:
    """The exception (class name, message) each refused configuration
    raises under a mesh (``payload['mesh']``, or the case's own)."""
    import repro_torch.core as T
    from repro_torch.serving import PMVServer

    meshes = {}
    out = {}
    for name, cls, kw in payload["cases"]:
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


TASKS = {"engine_cases": engine_cases, "batched_hier": batched_hier, "serve": serve,
         "checkpoint": checkpoint, "refusals": refusals}
