"""Would ``stream='auto'`` stream the vertical solves the port runs?  For
RMAT graphs (the paper's a,b,c,d, 16 edges a vertex, cyclic ψ) at several
scales and worker counts, compute the structural exchange capacity (the
largest partial v^(i,j)) and the cost model's two live-buffer profiles,
and say whether ``cost_model.prefer_streamed`` picks the streamed executor
(it needs a saving of ``STREAM_MIN_SAVINGS``).  Host numpy only; no card.

    python3 tools/stream_savings.py [--cases 18:8,18:32,18:64,20:32,20:64]

Prints one JSON line per case.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core.blocks import structural_partial_nnz  # noqa: E402
from repro_torch.core.partition import Partition  # noqa: E402
from repro_torch.graph import rmat  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="18:8,18:32,18:64,20:32,20:64",
                    help="comma-separated scale:b pairs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    graphs = {}
    for case in args.cases.split(","):
        scale, b = (int(x) for x in case.split(":"))
        if scale not in graphs:
            graphs[scale] = rmat(scale, 16 << scale, seed=args.seed)
        edges = graphs[scale]
        t = time.perf_counter()
        part = Partition(n=1 << scale, b=b, psi="cyclic")
        src, dst = edges[:, 0], edges[:, 1]
        nnz = structural_partial_nnz(part.block_of(dst), part.local_of(dst),
                                     part.block_of(src), b)
        cap = max(int(nnz.max()), 1)
        nl = part.n_local
        mat = cost_model.materialized_partial_elems(b, nl)
        strm = cost_model.streamed_partial_elems(b, nl, cap)
        print(json.dumps({
            "scale": scale, "b": b, "n_local": nl, "edges": int(len(edges)),
            "capacity": cap, "capacity_over_n_local": round(cap / nl, 4),
            "materialized_elems": mat, "streamed_elems": strm,
            "savings": round(mat / strm, 4), "needs": cost_model.STREAM_MIN_SAVINGS,
            "streams": cost_model.prefer_streamed(b, nl, cap),
            "seconds": round(time.perf_counter() - t, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
