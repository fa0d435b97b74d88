"""Query-serving example on the PyTorch port (the counterpart of
``examples/serve_queries.py``): 256 mixed RWR / SSSP queries against ONE
pre-partitioned RMAT graph through the continuous-batching PMVServer.

    PYTHONPATH=src python examples/serve_queries_torch.py [--device cuda|cpu]

The server groups queries by algorithm family (they cannot share a semiring),
packs each family into fixed Q-bucket batches, retires converged columns and
admits waiting queries mid-loop.  The partition and the batched step are
built once per family and reused for every batch.  Runs on the GPU unless
``--device cpu`` is given, and raises when no CUDA device is there.
``main(argv)`` returns a summary dict.
"""
import argparse
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.graph import rmat
from repro_torch.serving import PMVServer, Query


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edges", type=int, default=30_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, n_queries = 1 << args.scale, args.queries
    edges = rmat(args.scale, args.edges, seed=23)
    rng = np.random.default_rng(4)

    queries = []
    for i in range(n_queries):
        src = int(rng.integers(0, n))
        if i % 2 == 0:
            queries.append(Query("rwr", source=src, tol=1e-6))
        else:
            queries.append(Query("sssp", source=src, tol=0.5))

    srv = PMVServer(edges, n, b=4, strategy="selective", buckets=(16, 32, 64),
                    max_iters=500, device=dev)
    t0 = time.perf_counter()
    results = srv.serve(queries)
    dt = time.perf_counter() - t0

    stats = srv.stats()
    lat = np.array([r.latency_s for r in results])
    iters = np.array([r.iterations for r in results])
    conv = sum(r.converged for r in results)
    print(f"[serve] {n_queries} queries ({(n_queries + 1) // 2} rwr + {n_queries // 2} sssp) "
          f"on |V|={n} |E|={len(edges)}: {n_queries / dt:.1f} queries/s")
    print(f"[serve] converged {conv}/{n_queries}; iterations p50={np.median(iters):.0f} "
          f"max={iters.max()}; latency p50={np.median(lat) * 1e3:.0f}ms "
          f"p99={np.quantile(lat, 0.99) * 1e3:.0f}ms")
    print(f"[serve] {stats['batches']} batches, {stats['admitted_mid_batch']} mid-batch "
          f"admissions, {stats['iterations']:.0f} batched GIM-V iterations total")

    r = results[0]
    top = np.argsort(r.vector)[::-1][:5]
    print(f"[serve] sample rwr source={r.query.source}: top-5 vertices {top.tolist()}")
    return {"n": n, "edges": edges, "queries_per_s": n_queries / dt,
            "results": [{"kind": r.query.spec_kind, "source": r.query.source,
                         "vector": r.vector, "iterations": r.iterations,
                         "converged": r.converged} for r in results],
            "stats": {k: stats[k] for k in ("batches", "admitted_mid_batch", "iterations")}}


if __name__ == "__main__":
    main()
