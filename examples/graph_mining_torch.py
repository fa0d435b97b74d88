"""End-to-end graph mining on the PyTorch port (the counterpart of
``examples/graph_mining.py``): all four Table-2 algorithms on a
web-scale-shaped RMAT graph, with strategy selection, θ* optimization,
fault-tolerant checkpointing, and the per-iteration I/O accounting that
reproduces the paper's headline claims.

    PYTHONPATH=src python examples/graph_mining_torch.py [--log2n 14] \
        [--edges 500000] [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
device is there.  ``main(argv)`` returns a summary dict.
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch.core import (
    PMVEngine,
    connected_components,
    cost_model,
    pagerank,
    random_walk_with_restart,
    rwr_context,
    sssp,
)
from repro_torch.device import resolve_device
from repro_torch.graph import compute_stats, rmat


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=13)
    ap.add_argument("--edges", type=int, default=300_000)
    ap.add_argument("--b", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = 1 << args.log2n
    t0 = time.time()
    edges = rmat(args.log2n, args.edges, seed=42)
    stats = compute_stats(edges, n)
    print(f"RMAT graph: {n} vertices, {len(edges)} edges, "
          f"density {stats.density:.2e}, max out-degree {stats.out_deg.max()} "
          f"({time.time() - t0:.1f}s)")

    # cost-model decisions, exactly as the paper prescribes
    strategy = cost_model.select_strategy(args.b, n, len(edges))
    theta, cost = cost_model.theta_star(args.b, n, stats)
    print(f"Eq.5 selective choice: {strategy}; Lemma-3.3 θ* = {theta} "
          f"(expected I/O {cost:.0f} elems/iter)")

    summary = {"n": n, "edges": edges, "b": args.b, "strategy": strategy, "theta_star": theta,
               "cost": cost, "runs": {}}
    with tempfile.TemporaryDirectory() as ckpt:
        runs = [
            ("PageRank", pagerank(n), None, dict(max_iters=100, tol=1e-6), {}),
            ("RWR(src=7)", random_walk_with_restart(n, 7), rwr_context(n, 7),
             dict(max_iters=100, tol=1e-6), {}),
            ("SSSP(src=0)", sssp(0), None, dict(max_iters=n, tol=0.5), {}),
            ("ConnectedComponents", connected_components(), None,
             dict(max_iters=n, tol=0.5), dict(symmetrize=True)),
        ]
        for name, spec, ctx, kw, ekw in runs:
            eng = PMVEngine(edges, n, b=args.b, strategy="hybrid", theta="auto", device=dev,
                            **ekw)
            t0 = time.time()
            res = eng.run(spec, ctx, checkpoint_dir=f"{ckpt}/{name}",
                          checkpoint_every=10, **kw)
            wall = time.time() - t0
            io = res.per_iter[-1]["io_elems"]
            print(f"{name:22s} iters={res.iterations:3d} converged={res.converged} "
                  f"wall={wall:6.1f}s io/iter={io:9.0f} elems "
                  f"(θ={res.theta}, cap={res.capacity})")
            if name == "PageRank":
                assert abs(res.v.sum() - 1.0) < 0.2  # dangling leak only
            if name == "ConnectedComponents":
                n_comp = len(np.unique(res.v))
                print(f"{'':22s} -> {n_comp} components")
            summary["runs"][name] = {"v": res.v, "iterations": res.iterations,
                                     "converged": res.converged, "theta": res.theta,
                                     "capacity": res.capacity, "io_elems": io,
                                     "wall_s": wall}
    return summary


if __name__ == "__main__":
    main()
