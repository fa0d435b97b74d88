"""Quickstart on the PyTorch port: PageRank on a synthetic power-law graph
via PMV (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
device is there.  ``main(argv)`` returns a summary dict.
"""
import argparse

import numpy as np

from repro_torch.core import PMVEngine, pagerank
from repro_torch.device import resolve_device
from repro_torch.graph import rmat


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=12)
    ap.add_argument("--edges", type=int, default=120_000)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # RMAT graph with the paper's parameters (a=.57, b=.19, c=.19, d=.05)
    n = 1 << args.log2n
    edges = rmat(args.log2n, args.edges, seed=0)
    print(f"graph: {n} vertices, {len(edges)} edges")

    # Pre-partition once; strategy + θ chosen by the paper's cost model.
    engine = PMVEngine(edges, n, b=args.b, strategy="hybrid", theta="auto", device=dev)
    result = engine.run(pagerank(n), max_iters=120, tol=1e-6)

    print(f"strategy={result.strategy} θ={result.theta} "
          f"converged={result.converged} after {result.iterations} iterations")
    top = np.argsort(result.v)[::-1][:5]
    print("top-5 PageRank vertices:", list(zip(top.tolist(), np.round(result.v[top], 5).tolist())))
    io = result.per_iter[-1]["io_elems"]
    print(f"per-iteration I/O: {io:.0f} vector elements "
          f"(vs {len(edges) + n} for a re-shuffling baseline)")
    return {"n": n, "edges": edges, "b": args.b, "v": result.v,
            "iterations": result.iterations, "converged": result.converged,
            "strategy": result.strategy, "theta": result.theta, "io_elems": io,
            "top5": top.tolist()}


if __name__ == "__main__":
    main()
