"""Trace a disk-resident PageRank end to end on the PyTorch port
(``repro_torch.obs``; the counterpart of ``examples/trace_run.py``).

Ingests a synthetic graph into an out-of-core block store, solves PageRank
with residency='disk' under an enabled Recorder, and exports everything the
observability layer produces:

    trace_out/trace.json     Chrome trace-event JSON — open in Perfetto
                             (ui.perfetto.dev) or chrome://tracing; the disk
                             prefetch worker shows up as its own track.
    trace_out/metrics.jsonl  counters / gauges / histograms / series dump.

plus the live predicted-vs-measured report on stdout.

    PYTHONPATH=src python examples/trace_run_torch.py [--out trace_out] [--device cuda|cpu]

Runs on the GPU unless ``--device cpu`` is given, and raises when no CUDA
device is there.  ``main(argv)`` returns a summary dict.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch.core import PMVEngine, pagerank
from repro_torch.device import resolve_device
from repro_torch.graph import rmat
from repro_torch.obs import Recorder, calibration_summary
from repro_torch.store import ingest_edges


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=10)
    ap.add_argument("--edges", type=int, default=30_000)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--out", default="trace_out", help="directory of the trace and metrics")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU, raising without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = 1 << args.log2n
    edges = rmat(args.log2n, args.edges, seed=0)
    spec = pagerank(n)

    store_dir = tempfile.mkdtemp(prefix="pmv_store_")
    try:
        ingest_edges(edges, n, args.b, store_dir)
        print(f"ingested {len(edges)} edges into {store_dir}")

        # One recorder covers prepare + every iteration's block launches and fetches.
        rec = Recorder()
        engine = PMVEngine(None, store=store_dir, residency="disk",
                           strategy="vertical", obs=rec, device=dev)
        result = engine.run(spec, max_iters=30, tol=1e-6)
        # The next iteration's first block is still being prefetched: let it
        # land, so the recorder holds every span of the run from here on.
        engine.close()
        print(f"converged={result.converged} after {result.iterations} iterations; "
              f"read {result.totals['store_bytes_read']:.0f} B from disk "
              f"(prefetch overlap {result.totals['store_overlap']:.2f})")

        os.makedirs(args.out, exist_ok=True)
        trace_path = os.path.join(args.out, "trace.json")
        metrics_path = os.path.join(args.out, "metrics.jsonl")
        rec.write_chrome_trace(trace_path)
        rec.write_metrics_jsonl(metrics_path)
        print(f"wrote {trace_path} ({len(rec.events)} spans) — "
              "load it in ui.perfetto.dev")

        # Predicted-vs-measured residuals per launch kind (the calibration feed).
        calibration = calibration_summary(rec)
        for kind, s in calibration.items():
            print(f"  {kind}: {s['launches']} launches, "
                  f"measured/predicted {s['ratio']:.1f}x")

        # The same instrumentation backs explain(live=True) on any engine:
        print()
        explain = engine.explain(spec, live=True)
        print(explain)

        # Convergence trajectory comes free with every result (obs on or off).
        print()
        print("delta trajectory:", np.array2string(result.deltas[:8], precision=3),
              "...")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    return {"n": n, "edges": edges, "b": args.b, "v": result.v,
            "iterations": result.iterations, "converged": result.converged,
            "store_bytes_read": result.totals["store_bytes_read"],
            "io_elems": [r["io_elems"] for r in result.per_iter],
            "spans": len(rec.events), "calibration": calibration,
            "trace_path": trace_path, "metrics_path": metrics_path,
            "explain": explain, "deltas": result.deltas}


if __name__ == "__main__":
    main()
