"""Inspect the per-block ExecutionPlan the density-driven planner builds, on
the PyTorch port (the counterpart of ``examples/explain_plan.py``).

    PYTHONPATH=src python examples/explain_plan_torch.py [--device cuda|cpu]

``backend='auto'`` classifies every b x b pre-partitioned sub-block at
prepare() time into skip / ell (row-bucketed ELL slices) / dense (dense
matmul) tactics; ``PMVEngine.explain()`` pretty-prints the measured stats
(nnz, max in-degree, padding occupancy) and predicted per-block cost.
Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
device is there.  ``main(argv)`` returns a summary dict.
"""
import argparse

import numpy as np

from repro_torch.core import PMVEngine, pagerank, sssp
from repro_torch.device import resolve_device
from repro_torch.graph import rmat


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=10)
    ap.add_argument("--edges", type=int, default=14_000)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = 1 << args.log2n
    edges = rmat(args.log2n, args.edges, seed=0)
    # add a dense clique over one cyclic block so the plan mixes all tactics
    ids0 = np.arange(0, 256, 4)
    clique = np.array([(s, d) for s in ids0 for d in ids0])
    edges = np.concatenate([edges, clique])
    print(f"graph: {n} vertices, {len(edges)} edges (RMAT + one planted clique)\n")

    summary = {"n": n, "edges": edges, "explain": {}, "tactics": {}}
    for strategy in ("vertical", "hybrid"):
        engine = PMVEngine(edges, n, b=4, strategy=strategy, theta="auto",
                           backend="auto", device=dev)
        text = engine.explain(pagerank(n))
        print(text)
        print()
        plan = engine.prepare(pagerank(n))[-1]["plan"]
        summary["explain"][strategy] = text
        summary["tactics"][strategy] = [(bp.i, bp.j, bp.tactic) for bp in plan.blocks]

    # the plan is per-spec: an SSSP solve over the same matrix re-plans (weights
    # and symmetrization may differ) but hits the same partition host-side work
    engine = PMVEngine(edges, n, b=4, strategy="vertical", backend="auto", device=dev)
    text = engine.explain(sssp(0))
    print(text)
    summary["explain"]["sssp"] = text
    summary["tactics"]["sssp"] = [(bp.i, bp.j, bp.tactic)
                                  for bp in engine.prepare(sssp(0))[-1]["plan"].blocks]

    result = engine.run(sssp(0), max_iters=64, tol=0.0)
    reachable = int(np.isfinite(result.v).sum())
    print(f"\nsssp solved: {reachable} reachable vertices, "
          f"{result.iterations} iterations")
    summary.update(v=result.v, iterations=result.iterations, reachable=reachable)
    return summary


if __name__ == "__main__":
    main()
