"""Fleet observability walkthrough on the PyTorch port (the counterpart of
``examples/fleet_trace.py``): per-worker trace lanes, straggler
attribution, and live serving telemetry (repro_torch.obs.fleet /
repro_torch.obs.live).

Runs a W=4 SPMD out-of-core PageRank, one ``torch.distributed`` rank per
worker (gloo; on the GPU the ranks share the card and run deterministic
algorithms, so the traced, faulted solve is bitwise the clean one), with
per-worker recorder shards and an injected slow disk on worker 2, then:

    fleet_out/fleet_trace.json   merged Chrome trace — one lane per worker
                                 (open in ui.perfetto.dev; worker 2's
                                 store.fetch spans are visibly longer)
    fleet_out/fleet_report.json  the straggler report as JSON
    stdout                       fleet_report().format() — per-worker
                                 fetch/wait totals, skew, flagged stragglers

and finishes with a telemetry-enabled PMVServer: serves a few queries, then
scrapes its own OpenMetrics endpoint on localhost (the same `/metrics` a
Prometheus scraper or `python -m repro_torch obs top <url>` would hit).

    PYTHONPATH=src python examples/fleet_trace_torch.py [--out fleet_out] [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
device is there.  ``main(argv)`` starts the W rank processes (this file
with ``--rank``), waits for them and returns a summary dict.
"""
import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

RANK_TIMEOUT_S = 600.0


def _solve_rank(rank: int, d: str) -> int:
    """One worker's rank: the faulted, traced SPMD solve and the clean one;
    rank 0 writes the merged trace, the report and its results.  Leaves with
    ``os._exit`` after a last barrier, so no rank tears its gloo group down
    while a peer still talks to it."""
    import traceback

    code = 1
    try:
        with open(os.path.join(d, "payload.json")) as f:
            cfg = json.load(f)
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.core import PMVEngine, collectives, pagerank
        from repro_torch.faults import FaultPlan, SlowFetch
        from repro_torch.obs import (fleet_report, merge_traces, validate_chrome_trace,
                                     write_fleet_report)

        torch.set_num_threads(1)
        W = cfg["workers"]
        dev = collectives.rank_device(cfg["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            # the two solves must agree bitwise: PageRank's segment sums are
            # float atomics on the GPU unless deterministic algorithms are on
            torch.use_deterministic_algorithms(True, warn_only=True)
        dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous", rank=rank,
                                world_size=W)
        mesh = DeviceMesh(dev.type, torch.arange(W), mesh_dim_names=("workers",))
        spec = pagerank(cfg["n"])

        # -- SPMD solve: W workers, each with its own recorder shard; worker 2's
        #    reads of block 1 are injected 100 ms slower (a failing local disk).
        plan = FaultPlan(events=(SlowFetch(block=1, delay_s=0.1, occurrence=2,
                                           worker=2),), seed=0)
        engine = PMVEngine(None, store=cfg["store"], residency="disk",
                           strategy="vertical", mesh=mesh, obs=True, faults=plan, device=dev)
        result = engine.run(spec, max_iters=6, tol=1e-6)
        # the solve is bitwise the unfaulted, untraced one — tracing and the
        # injected straggler only change *timing*, never bytes
        clean = PMVEngine(None, store=cfg["store"], residency="disk",
                          strategy="vertical", mesh=mesh, device=dev).run(spec, max_iters=6,
                                                                          tol=1e-6)
        fleet = engine.prepare(spec)[-1]["store"].fleet_recorder()   # collective
        if rank == 0:
            doc = merge_traces(fleet)          # one pid lane per worker shard
            validate_chrome_trace(doc)
            with open(cfg["trace_path"], "w") as f:
                json.dump(doc, f)
            rep = fleet_report(result)         # who was slow, and why
            write_fleet_report(cfg["report_path"], rep)
            lanes = [ev["args"]["name"] for ev in doc["traceEvents"]
                     if ev.get("ph") == "M" and ev["name"] == "process_name"]
            out = {"v": result.v, "clean_v": clean.v, "iterations": result.iterations,
                   "converged": result.converged, "lanes": lanes,
                   "io_elems": [r["io_elems"] for r in result.per_iter],
                   "workers": rep.workers, "straggler_workers": rep.straggler_workers,
                   "causes": [x["cause"] for x in rep.stragglers], "skew": rep.skew,
                   "report": rep.format()}
            with open(os.path.join(d, "r0.tmp"), "wb") as f:
                pickle.dump(out, f)
            os.replace(os.path.join(d, "r0.tmp"), os.path.join(d, "r0.pkl"))
        dist.barrier()
        code = 0
    except BaseException:  # noqa: BLE001 -- reported through the rank's log and exit code
        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def _spawn(d: str, workers: int) -> list:
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    procs = []
    for rank in range(workers):
        log = open(os.path.join(d, f"r{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank", str(rank),
             "--spmd-dir", d], env={**env, "LOCAL_RANK": str(rank)}, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _wait(d: str, procs: list) -> dict:
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"the worker ranks are still running after {RANK_TIMEOUT_S:.0f} s")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    codes = [p.returncode for p, _ in procs]
    if any(codes) or not os.path.exists(os.path.join(d, "r0.pkl")):
        logs = "\n".join(f"--- rank {i} (exit {c}) ---\n" + Path(d, f"r{i}.log").read_text(
            errors="replace")[-2000:] for i, c in enumerate(codes))
        raise RuntimeError(f"the worker ranks failed, exit codes {codes}:\n{logs}")
    with open(os.path.join(d, "r0.pkl"), "rb") as f:
        return pickle.load(f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=9)
    ap.add_argument("--edges", type=int, default=5_000)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--out", default="fleet_out", help="directory of the trace and report")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spmd-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _solve_rank(args.rank, args.spmd_dir)

    from repro_torch.device import resolve_device
    from repro_torch.graph import rmat
    from repro_torch.obs import TelemetryConfig
    from repro_torch.serving import PMVServer, Query
    from repro_torch.store import ingest_edges

    dev = resolve_device(args.device)
    n, b, W = 1 << args.log2n, args.b, args.workers
    edges = rmat(args.log2n, args.edges, seed=0)
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, "fleet_trace.json")
    report_path = os.path.join(args.out, "fleet_report.json")

    d = tempfile.mkdtemp(prefix="pmv_fleet_")
    try:
        store_dir = os.path.join(d, "store")
        ingest_edges(edges, n, b, store_dir)
        print(f"ingested {len(edges)} edges into {store_dir}")
        with open(os.path.join(d, "payload.json"), "w") as f:
            json.dump({"workers": W, "device": dev.type, "n": n, "store": store_dir,
                       "trace_path": os.path.abspath(trace_path),
                       "report_path": os.path.abspath(report_path)}, f)
        res = _wait(d, _spawn(d, W))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"converged={res['converged']} after {res['iterations']} iterations "
          f"across {W} workers")
    bitwise = bool(np.array_equal(res["clean_v"], res["v"]))
    if not bitwise:
        raise RuntimeError("the traced, faulted solve is not bitwise the clean one")
    print(f"wrote {trace_path} — lanes: {res['lanes']}")
    print(res["report"])

    # -- live serving telemetry: rolling p99 + SLO burn over the retirement
    #    ledger, scraped from the server's own OpenMetrics endpoint.
    srv = PMVServer(edges, n, b=b, strategy="vertical", buckets=(4,), obs=True,
                    telemetry=TelemetryConfig(latency_target_s=30.0), device=dev)
    try:
        served = srv.serve([Query("rwr", source=i, tol=1e-6, deadline_s=60.0)
                            for i in range(4)])
        with urllib.request.urlopen(srv.telemetry.url + "/metrics") as resp:
            scrape = resp.read().decode()
        slo_lines = [ln for ln in scrape.splitlines() if ln.startswith("pmv_slo")]
        print(f"\nscraped {srv.telemetry.url}/metrics "
              f"({len(scrape.splitlines())} lines); SLO gauges:")
        print("\n".join(f"  {ln}" for ln in slo_lines[:8]))
        burn = srv.stats()["slo"]["latency"]["total"]["burn_rate"]
        print(f"\nstats()['slo'] latency burn (total): {burn}")
    finally:
        srv.close()
    return {**res, "n": n, "edges": edges, "b": b, "bitwise": bitwise,
            "trace_path": trace_path, "report_path": report_path,
            "served": [r.vector for r in served], "scrape_lines": len(scrape.splitlines()),
            "slo_lines": slo_lines, "burn_rate": burn}


if __name__ == "__main__":
    main()
