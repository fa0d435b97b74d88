"""The two ELL kernels against their library yardsticks on an H100, in
alternating rounds.

On the RMAT graph of ``chip_smoke.py`` (scale 20, edge factor 16, b = 8)
this prepares the PageRank run's planned tables (strategy='selective') and
the RWR serve family's sparse region (``PMVServer(strategy='hybrid',
theta=3000)``), then times with CUDA events, in rounds where the sides
take turns to go first:

- ``ell_gimv`` plus_times against CSR ``torch.mv`` over the same valid
  slots, on PageRank's largest bucket (most slots of the layout), its
  widest bucket, and every bucket of one iteration summed;
- ``ell_gimv_multi`` plus_times at Q = 64 against CSR ``torch.sparse.mm``,
  on the RWR family's largest and widest buckets and all of them summed;
- both on short rows in a bucket wider than the kernels' split (2048): the
  largest bucket's rows (the first 800,000 for the Q-wide kernel) padded to
  2048 slots, as the lowest bucket of a graph whose longest row is over 128
  times the split would hold them, with the kernel on the same rows at
  their own width as a third side ("narrow").

Each kernel is first held against its plain version (the library's largest
relative error from it is reported: cuSPARSE sums long rows in another
order).  With ``--parent DIR`` (a ``kernels/csrc`` directory of another
checkout) the same two entry points are also built from DIR and timed as a
third side, and checked on every bucket for 4 semirings and int32 min_src:
the same bits as this tree's kernels on buckets up to 1024 slots wide (one
warp a row in both), allclose for plus_times and equal otherwise on the
wider ones.  Run on a machine with one CUDA card, from the repository root:

    python3 tools/bench_ell.py [--scale 20] [--rounds 6] [--reps 20] [--parent DIR]

Prints the card's name and power limit, one line a round, then one JSON
object.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

from benchlib import alternate, card_line, load_entries


def csr_of(torch, bk, n_src):
    """The bucket's valid slots as a CSR matrix [rows, n_src]."""
    valid = bk.cols >= 0
    crow = torch.zeros(bk.cols.shape[0] + 1, dtype=torch.int64, device=bk.cols.device)
    crow[1:] = torch.cumsum(valid.sum(dim=1), 0)
    return torch.sparse_csr_tensor(crow, bk.cols[valid].to(torch.int64), bk.w[valid],
                                   size=(bk.cols.shape[0], n_src))


def pair(torch, ell, ref, buckets, v, lib_call):
    """(kernel, library) callables over ``buckets`` and the library's largest
    relative error: the kernel is held against its plain version ``ref``
    (rtol 1e-5, atol scaled to the data as in chip_smoke.py), the library
    only measured against it (cuSPARSE sums a long row in another order)."""
    csrs = [csr_of(torch, bk, v.shape[0]) for bk in buckets]
    lib_err = 0.0
    for bk, csr in zip(buckets, csrs):
        want = ref(bk.cols, bk.w, v, semiring="plus_times")
        got = ell(bk.cols, bk.w, v, semiring="plus_times")
        scale = float(want.abs().max()) if want.numel() else 1.0
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6 * min(1.0, scale)):
            raise SystemExit(f"kernel and its plain version differ on {list(bk.cols.shape)}")
        rel = (lib_call(csr, v) - want).abs() / want.abs().clamp_min(1e-30)
        lib_err = max(lib_err, float(rel.max()) if rel.numel() else 0.0)

    def kernel():
        for bk in buckets:
            ell(bk.cols, bk.w, v, semiring="plus_times")

    def library():
        for csr in csrs:
            lib_call(csr, v)
    return kernel, library, lib_err


def widened(torch, bk, width: int, rows: int | None = None):
    """The bucket's first ``rows`` rows (all by default) with pads appended
    up to ``width`` slots."""
    cols, w = bk.cols[:rows], bk.w[:rows]
    pad = width - cols.shape[1]
    return SimpleNamespace(
        cols=torch.cat([cols, cols.new_full((cols.shape[0], pad), -1)], dim=1),
        w=torch.cat([w, w.new_zeros((w.shape[0], pad))], dim=1))


def load_parent(torch, csrc: Path) -> dict:
    """ell_gimv / ell_gimv_multi built from another tree's csrc, as wrappers
    with this tree's signature (no launch counts, no checks)."""
    from repro_torch.kernels import _common, build

    fns = load_entries({"parent": csrc}, ("ell_gimv", "ell_gimv_multi"),
                       build.build_dir() / "bench_ell")["parent"]
    calls = {}
    for name, fn in fns.items():
        def call(cols, w, v, *, semiring, fn=fn, name=name):
            out = torch.empty((cols.shape[0],) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device)
            extra = (v.shape[1],) if v.ndim == 2 else ()
            rc = fn(cols.data_ptr(), None if w is None else w.data_ptr(), v.data_ptr(),
                    out.data_ptr(), cols.shape[0], cols.shape[1], *extra,
                    _common.SEMIRING_ID[semiring], _common.VALUE_TYPE_ID[v.dtype],
                    _common.current_stream(v.device))
            build.check_rc(rc, f"parent {name}")
            return out
        calls[name] = call
    return calls


def parent_bits(torch, gen, ell, parent, buckets, v) -> dict:
    """This tree's kernel against the parent's on every bucket, for 4
    semirings and int32 min_src on random vectors shaped like ``v``."""
    sweep = (("plus_times", torch.float32), ("min_plus", torch.float32),
             ("max_plus", torch.float32), ("min_src", torch.float32), ("min_src", torch.int32))
    same = differ = 0
    for sr, dt in sweep:
        if dt == torch.int32:
            x = torch.randint(0, 1000, tuple(v.shape), generator=gen, device=v.device,
                              dtype=torch.int32)
        else:
            x = torch.rand(tuple(v.shape), generator=gen, device=v.device)
        for bk in buckets:
            got, want = ell(bk.cols, bk.w, x, semiring=sr), parent(bk.cols, bk.w, x, semiring=sr)
            if torch.equal(got, want):
                same += 1
                continue
            differ += 1
            if bk.cols.shape[1] <= 1024 or sr != "plus_times" or dt != torch.float32:
                raise SystemExit(f"{list(bk.cols.shape)} {sr} {dt}: differs from the parent")
            atol = 1e-6 * min(1.0, float(want.abs().max()))
            if not torch.allclose(got, want, rtol=1e-5, atol=atol):
                raise SystemExit(f"{list(bk.cols.shape)} plus_times: not close to the parent")
    return {"bitwise_equal": same, "plus_times_close_not_bitwise": differ}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a kernels/csrc directory whose two ELL kernels are timed beside these")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    from repro_torch.core import PMVEngine, pagerank
    from repro_torch.graph import rmat
    from repro_torch.kernels import ell_spmv
    from repro_torch.serving import PMVServer, Query

    warnings.filterwarnings("ignore", message="Sparse")
    print(f"card: {card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    n = 1 << args.scale
    edges = rmat(args.scale, 16 << args.scale, seed=args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    cases = {}
    eng = PMVEngine(edges, n, b=8, strategy="selective", backend="auto", device=dev)
    matrix, v0 = eng.prepare(pagerank(n))[:2]
    fp = matrix["planned"]
    v = torch.rand(v0.numel(), device=dev, generator=gen)   # the flat gathered vector
    cases["ell_gimv"] = (ell_spmv.ell_gimv, ell_spmv.ell_gimv_ref, fp.buckets, v, torch.mv, None)
    srv = PMVServer(edges, n, b=8, strategy="hybrid", theta=3000.0, backend="auto",
                    scatter="kernel", stream="off", device=dev)
    seng, fspec = srv.engine_for(Query("rwr", source=1, c=0.85, tol=1e-6))
    smatrix, sv0 = seng.prepare(fspec)[:2]
    vq = torch.rand((sv0.numel(), 64), device=dev, generator=gen)
    cases["ell_gimv_multi"] = (ell_spmv.ell_gimv_multi, ell_spmv.ell_gimv_multi_ref,
                               smatrix["planned_sparse"].buckets, vq, torch.sparse.mm, 800_000)

    parents = load_parent(torch, args.parent) if args.parent else {}
    result = {"device": torch.cuda.get_device_name(0), "card": card_line(),
              "rounds": args.rounds, "reps": args.reps}
    for name, (ell, ref, buckets, vec, lib_call, short_rows) in cases.items():
        if name in parents:
            result[f"{name}_vs_parent"] = parent_bits(torch, gen, ell, parents[name], buckets, vec)
        largest = max(buckets, key=lambda bk: bk.cols.numel())
        widest = max(buckets, key=lambda bk: bk.cols.shape[1])
        narrow = SimpleNamespace(cols=largest.cols[:short_rows], w=largest.w[:short_rows])
        for which, sel in (("largest", [largest]), ("widest", [widest]), ("all", list(buckets)),
                           ("short_rows_2048", [widened(torch, largest, 2048, short_rows)])):
            kernel, library, lib_err = pair(torch, ell, ref, sel, vec, lib_call)
            sides = [("kernel", kernel), ("library", library)]
            if which == "short_rows_2048":
                sides.append(("narrow", pair(torch, ell, ref, [narrow], vec, lib_call)[0]))
            if name in parents:
                sides.append(("parent", pair(torch, parents[name], ref, sel, vec, lib_call)[0]))
            got = alternate(torch, sides, args.rounds, args.reps, f"{name} {which}")
            ratio = [b / a for a, b in zip(got["kernel"], got["library"])]
            result[f"{name}_{which}"] = {
                "shapes": [list(bk.cols.shape) for bk in sel],
                "valid_slots": int(sum(int((bk.cols >= 0).sum()) for bk in sel)),
                "nq": vec.shape[1] if vec.ndim == 2 else None,
                **{f"{side}_ms": got[side] for side, _ in sides},
                **{f"{side}_ms_median": statistics.median(got[side]) for side, _ in sides},
                "library_over_kernel_per_round": ratio, "library_max_rel_err": lib_err,
                "kernel_faster_every_round": all(x > 1.0 for x in ratio)}
            del sel, kernel, library, sides
            torch.cuda.empty_cache()
    srv.close()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
