"""Fault-injected out-of-core PageRank that recovers bitwise, on the PyTorch
port (``repro_torch.faults``; the counterpart of ``examples/chaos_run.py``).

Ingests a synthetic graph into a checksummed block store, then runs the same
disk-residency PageRank twice: once clean, once under a seeded FaultPlan
that corrupts a fetched shard slice (caught by the manifest checksums and
re-fetched), throws two transient IOErrors (absorbed by the bounded-retry
layer), and kills the run mid-iteration (resumed from the atomic
checkpoint).  The recovered result is bitwise identical to the clean one.
On the GPU both solves run under ``torch.use_deterministic_algorithms``:
PageRank's segment sums are float atomics there otherwise, and two runs
differ in their last bits.

    PYTHONPATH=src python examples/chaos_run_torch.py [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
device is there.  ``main(argv)`` returns a summary dict.
"""
import argparse
import contextlib
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.core import PMVEngine, pagerank
from repro_torch.device import resolve_device
from repro_torch.faults import (
    CorruptFetch,
    FaultPlan,
    InjectedKill,
    KillAtIteration,
    RetryPolicy,
    TransientIO,
)
from repro_torch.graph import rmat
from repro_torch.obs import Recorder
from repro_torch.store import ingest_edges, verify_store

COUNTERS = ("fault.injected.corrupt_fetch", "fault.injected.transient_io",
            "fault.injected.kill", "fault.retry", "fault.recovered",
            "store.verify_failures")


@contextlib.contextmanager
def deterministic(dev):
    """Deterministic algorithms on the GPU for solves that must agree
    bitwise (the previous setting restored after); nothing on the CPU."""
    if dev.type != "cuda":
        yield
        return
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=10)
    ap.add_argument("--edges", type=int, default=30_000)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = 1 << args.log2n
    edges = rmat(args.log2n, args.edges, seed=0)

    store_dir = tempfile.mkdtemp(prefix="pmv_store_")
    try:
        with deterministic(dev):
            ingest_edges(edges, n, args.b, store_dir)
            audit = verify_store(store_dir)
            print(f"ingested {len(edges)} edges; store audit: "
                  f"{audit.checked} digests checked, ok={audit.ok}")

            # the reference: no faults
            clean = PMVEngine(None, store=store_dir, residency="disk",
                              strategy="vertical", device=dev)
            ref = clean.run(pagerank(n), max_iters=20, tol=0.0)

            # the chaos run: every event is seeded, so this script replays exactly
            plan = FaultPlan(events=(
                CorruptFetch(block=2, array="seg"),   # flipped byte in a fetched slice
                TransientIO(block=3),                 # two transient read failures
                TransientIO(block=5),
                KillAtIteration(iteration=10),        # crash halfway through the solve
            ), seed=7)
            rec = Recorder()
            ckpt = os.path.join(store_dir, "ckpt")
            engine = PMVEngine(None, store=store_dir, residency="disk",
                               strategy="vertical", faults=plan,
                               io_retry=RetryPolicy(max_attempts=3, base_delay_s=1e-3),
                               obs=rec, device=dev)
            killed = None
            try:
                engine.run(pagerank(n), max_iters=20, tol=0.0,
                           checkpoint_dir=ckpt, checkpoint_every=2)
            except InjectedKill as e:
                killed = str(e)
                print(f"killed mid-run: {e}")

            # same engine, resume=True: the consumed kill stays consumed, the solve
            # replays from the last checkpoint deterministically
            result = engine.run(pagerank(n), max_iters=20, tol=0.0,
                                checkpoint_dir=ckpt, checkpoint_every=2, resume=True)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    bitwise = bool(np.array_equal(ref.v, result.v))
    print(f"recovered result bitwise equal to fault-free run: {bitwise}")
    remaining = engine._fault_injector.remaining
    print(f"faults still unfired: {remaining}")
    counters = {}
    for name in COUNTERS:
        inst = rec.metrics.get(name)
        if inst is not None:
            counters[name] = inst.to_dict()["value"]
            print(f"  {name} = {counters[name]:.0f}")
    return {"n": n, "edges": edges, "b": args.b, "audit": (audit.checked, audit.ok),
            "clean_v": ref.v, "v": result.v, "iterations": result.iterations,
            "killed": killed, "bitwise": bitwise, "remaining": remaining,
            "counters": counters}


if __name__ == "__main__":
    main()
