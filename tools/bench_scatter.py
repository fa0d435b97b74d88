"""The two single-vector receive folds (``scatter_combine``, kernel 3, and
``packed_scatter_combine``, kernel 7) against their library yardsticks on
an H100, in alternating rounds.

On the RMAT graph of ``chip_smoke.py`` (scale 20, edge factor 16, b = 8)
this builds the smoke's two single-vector exchange buffers:

- the SSSP run's (``strategy='vertical'``, ``scatter='kernel'``, solved
  from vertex 0): the compacted (idx, val) of one step from the converged
  state with half its entries set to infinity (drawn from ``--seed``), as
  ``sparse_exchange.compact_partials`` gives them;
- the packed PageRank run's (``exchange='packed'``, ``delta_eps=0``): the
  words and the payload gathered from a uniform random state.

Each side is captured as 20 back-to-back calls in one CUDA graph and timed
by CUDA events over graph replays, in rounds where the sides take turns to
go first, so a side's time is its device time and not the host's work
between launches (an eager call of the wrapper is printed beside it):

- kernel 3 min_plus on the SSSP values against ``index_reduce_('amin')``
  at the valid slots;
- kernel 3 plus_times on random values at the SSSP slots against
  ``index_add_`` at the valid slots;
- kernel 7 plus_times on the packed payload against ``index_add_`` of the
  structural slots at pre-decoded ids.

Each kernel is first held against its plain version (plus_times rtol 1e-5,
the others exactly).  With ``--parent DIR`` (a ``kernels/csrc`` directory
of another checkout) the two entry points are also built from DIR, timed as
a further side, and held to the same bits as this tree's kernels on both
buffers for 4 semirings and int32 min_src.  With ``--variants`` the two
are also built from copies of this tree's csrc that differ only in
``scatter_tile.cuh``'s constants of the single-vector fold (threads a
block, slots a thread per chunk, output rows a tile, blocks an SM;
``VARIANTS`` below),
each held to this tree's bits and timed as a side of its own.  Run on a
machine with one CUDA card, from the repository root:

    python3 tools/bench_scatter.py [--scale 20] [--rounds 6] [--reps 5]
                                   [--parent DIR] [--variants]

Prints the card's name and power limit, each tree's registers a thread
(``nvcc -Xptxas -v``), one line a round, then one JSON object.  Exits 1
without a card, and on a kernel that disagrees.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import warnings
from pathlib import Path

from bench_scatter_multi import SWEEP, random_values, variant_csrc
from benchlib import alternate, card_line, event_ms, graphed, load_entries

NAMES = ("scatter_combine", "packed_scatter_combine")
CALLS = 20   # calls captured in one graph
# scatter_tile.cuh's single-vector constants in each variant: threads a
# block, slots a thread per chunk, output rows a tile, and the blocks an SM
# that __launch_bounds__ asks for (which caps the registers at
# 65536 / (threads * blocks)).  This tree's own constants are the side
# "kernel" and are left out here.
VARIANTS = {
    f"t{t}_i{i}_r{r}_b{m}": dict(kScalarThreads=t, kScalarItems=i, kScalarTileRows=r,
                                 kScalarBlocksPerSm=m)
    for t, i, r, m in ((256, 4, 1024, 1), (256, 4, 1024, 5), (256, 4, 1024, 7),
                       (256, 4, 1024, 8), (256, 8, 1024, 6), (256, 2, 1024, 6),
                       (256, 4, 2048, 6), (256, 4, 512, 6), (256, 8, 2048, 6),
                       (256, 8, 2048, 4), (512, 8, 2048, 3), (512, 8, 2048, 1),
                       (512, 4, 1024, 3))}


# the float32 kernel-3 min_plus and kernel-7 plus_times (32-bit ids) entries,
# by their mangled names
REGISTER_ENTRIES = {"scatter_combine": "20scatter_combine_tileILi1EfE",
                    "packed_scatter_combine": "27packed_scatter_combine_tileILi0EfLi32E"}


def ptxas_registers(trees: dict[str, Path], out_root: Path) -> dict[str, dict[str, int]]:
    """{tag: {kernel: registers a thread}} of REGISTER_ENTRIES in each csrc
    tree, from ``nvcc -Xptxas -v`` at this tree's flags (cubins, one nvcc
    each, all at once); a tree without such an entry (another design) has
    none."""
    import re
    import subprocess

    from repro_torch.kernels import build

    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = {}
    for tag, csrc in trees.items():
        for name in NAMES:
            cubin = out_root / tag / f"{name}.cubin"
            cubin.parent.mkdir(parents=True, exist_ok=True)
            procs[tag, name] = subprocess.Popen(
                [build._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-I", str(csrc), "-o",
                 str(cubin), str(csrc / build.SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {tag: {} for tag in trees}
    for (tag, name), proc in procs.items():
        entry = None
        for line in proc.communicate()[0].splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif entry and REGISTER_ENTRIES[name] in entry and (m := re.search(
                    r"Used (\d+) registers", line)):
                regs[tag][name] = int(m.group(1))
                entry = None
    return regs


def load_tree(torch, entries: dict, tag: str) -> dict:
    """The two single-vector scatter entry points of one built tree, as
    calls with this tree's wrappers' arguments (no launch counts, no
    checks)."""
    from repro_torch.kernels import _common, build

    def sparse(idx, val, n_local, *, semiring):
        sets, senders, cap = val.shape
        out = torch.empty((sets, n_local), dtype=val.dtype, device=val.device)
        rc = entries[NAMES[0]](idx.data_ptr(), val.data_ptr(), out.data_ptr(), sets, senders,
                               cap, n_local, _common.SEMIRING_ID[semiring],
                               _common.VALUE_TYPE_ID[val.dtype],
                               _common.current_stream(val.device))
        build.check_rc(rc, f"{tag} {NAMES[0]}")
        return out

    def packed(words, val, n_out, *, set_slots, n_local, width, semiring, senders):
        out = torch.empty((n_out,), dtype=val.dtype, device=val.device)
        rc = entries[NAMES[1]](words.data_ptr(), val.data_ptr(), out.data_ptr(),
                               val.shape[0] // set_slots, set_slots, senders, n_local, n_out,
                               width, _common.SEMIRING_ID[semiring],
                               _common.VALUE_TYPE_ID[val.dtype],
                               _common.current_stream(val.device))
        build.check_rc(rc, f"{tag} {NAMES[1]}")
        return out
    return {NAMES[0]: sparse, NAMES[1]: packed}


def buffers(torch, args, dev, gen) -> dict:
    """The SSSP run's compacted buffers and the packed PageRank run's."""
    import numpy as np

    from repro_torch.core import PMVEngine, pagerank, placement, sparse_exchange, sssp
    from repro_torch.exchange import gather_payload
    from repro_torch.graph import rmat

    n, b = 1 << args.scale, 8
    edges = rmat(args.scale, 16 << args.scale, seed=args.seed)
    eng = PMVEngine(edges, n, b=b, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device=dev)
    spec = sssp(0)
    res = eng.run(spec, max_iters=100, tol=0.5)
    matrix, _, _, _, meta = eng.prepare(spec)
    part = meta["part"]
    nl = part.n_local
    v = torch.from_numpy(part.to_blocked(res.v.astype(np.float32)).copy()).to(dev)
    v = torch.where(torch.rand(v.shape, generator=gen, device=dev) < 0.5, v,
                    torch.full_like(v, float("inf")))
    partials = placement._planned_vertical_partials(spec, matrix["planned"], v, nl)
    idx, val, _, _ = sparse_exchange.compact_partials(spec, partials, meta["capacity"])
    sssp_buf = dict(n_local=nl, idx=idx.transpose(0, 1).contiguous(),
                    val=val.transpose(0, 1).contiguous())
    del eng, matrix, partials, idx, val
    eng = PMVEngine(edges, n, b=b, strategy="vertical", backend="auto", scatter="kernel",
                    exchange="packed", delta_eps=0.0, device=dev)
    spec = pagerank(n)
    matrix, _, _, _, meta = eng.prepare(spec)
    xp, xchg, nl = meta["cfg"].xplan, matrix["xchg"], meta["part"].n_local
    v = torch.rand((b, nl), generator=gen, device=dev)
    partials = placement._planned_vertical_partials(spec, matrix["planned"], v, nl)
    payload = gather_payload(spec, partials, xchg["send_rows"])
    packed_buf = dict(n_local=nl, words=xchg["recv_words"].reshape(-1),
                      val=payload.transpose(0, 1).contiguous().reshape(-1),
                      kw=dict(set_slots=b * xp.p_dev, n_local=nl, width=xp.width_dev, senders=b),
                      n_out=b * (nl + 1), structural=int((xchg["recv_rows"] < nl).sum()))
    del eng, matrix, partials, payload
    torch.cuda.empty_cache()
    return {"sssp": sssp_buf, "packed": packed_buf}


def cases(torch, gen, bufs):
    """(label, kind, semiring, kernel args) of each timed case."""
    sb = bufs["sssp"]
    return [("sssp_min_plus", "sparse", "min_plus", sb["val"]),
            ("sssp_plus_times", "sparse", "plus_times",
             torch.rand(sb["val"].shape, generator=gen, device=sb["val"].device)),
            ("packed_plus_times", "packed", "plus_times", bufs["packed"]["val"])]


def calls_of(torch, bufs, kind, sr, val, trees):
    """The kernel's call, its plain version's result, the library call at
    the valid (structural) slots with its name, and each other tree's
    call, on one case; also its valid-slot count."""
    from repro_torch.kernels import scatter_combine as sc
    from repro_torch.kernels.scatter_combine.ref import packed_targets

    if kind == "sparse":
        b_ = bufs["sssp"]
        idx, nl = b_["idx"], b_["n_local"]
        s_ = idx.shape[0]
        kernel = lambda: sc.scatter_combine_gimv(idx, val, nl, semiring=sr)  # noqa: E731
        want = sc.scatter_combine_ref(idx, val, nl, semiring=sr)
        flat = idx.reshape(s_, -1).to(torch.int64)
        keep = (flat < nl).reshape(-1)
        rows = (flat + torch.arange(s_, device=idx.device)[:, None] * nl).reshape(-1)[keep]
        n_rows = s_ * nl
        other = {tag: (lambda t=t: t[NAMES[0]](idx, val, nl, semiring=sr))
                 for tag, t in trees.items()}
    else:
        b_ = bufs["packed"]
        words, kw, n_out = b_["words"], b_["kw"], b_["n_out"]
        plain_kw = {k: v for k, v in kw.items() if k != "senders"}
        kernel = lambda: sc.packed_scatter_combine_gimv(  # noqa: E731
            words, val, n_out, semiring=sr, **kw)
        want = sc.packed_scatter_combine_ref(words, val, n_out, semiring=sr, **plain_kw)
        rows = packed_targets(words, val.shape[0], n_out, **plain_kw)
        keep = rows < n_out
        rows = rows[keep]
        n_rows = n_out
        other = {tag: (lambda t=t: t[NAMES[1]](words, val, n_out, semiring=sr, **kw))
                 for tag, t in trees.items()}
    vals = val.reshape(-1)[keep]
    if sr == "plus_times":
        base = torch.zeros((n_rows,), device=val.device)
        library = lambda: base.clone().index_add_(0, rows, vals)  # noqa: E731
        lib_name = "index_add_"
    else:
        base = torch.full((n_rows,), float("inf"), device=val.device)
        library = lambda: base.clone().index_reduce_(0, rows, vals, "amin")  # noqa: E731
        lib_name = "index_reduce_"
    return kernel, want, (lib_name, library), other, int(keep.sum())


def parent_bits(torch, gen, bufs, parent) -> int:
    """This tree's two kernels against the parent's on both buffers' slots
    for 4 semirings and int32 min_src; the count of cases."""
    from repro_torch.kernels import scatter_combine as sc

    cases_ = 0
    sb, pb = bufs["sssp"], bufs["packed"]
    for sr, dt in SWEEP:
        x = random_values(torch, gen, tuple(sb["val"].shape), sr, dt)
        got = sc.scatter_combine_gimv(sb["idx"], x, sb["n_local"], semiring=sr)
        if not torch.equal(got, parent[NAMES[0]](sb["idx"], x, sb["n_local"], semiring=sr)):
            raise SystemExit(f"sparse {sr} {dt}: differs from the parent")
        x = random_values(torch, gen, tuple(pb["val"].shape), sr, dt)
        got = sc.packed_scatter_combine_gimv(pb["words"], x, pb["n_out"], semiring=sr,
                                             **pb["kw"])
        if not torch.equal(got, parent[NAMES[1]](pb["words"], x, pb["n_out"], semiring=sr,
                                                 **pb["kw"])):
            raise SystemExit(f"packed {sr} {dt}: differs from the parent")
        cases_ += 2
    return cases_


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5, help="graph replays a round")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a kernels/csrc directory whose two single-vector scatter kernels are "
                         "timed beside these")
    ap.add_argument("--variants", action="store_true",
                    help="also time the single-vector fold's constant variants of VARIANTS")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    warnings.filterwarnings("ignore", message="index_reduce")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out_root = build.build_dir() / "bench_scatter"
    trees = {"parent": args.parent} if args.parent else {}
    if args.variants:
        trees.update({tag: variant_csrc(out_root / "src" / tag, consts)
                      for tag, consts in VARIANTS.items()})
    others = {tag: load_tree(torch, entries, tag)
              for tag, entries in load_entries(trees, NAMES, out_root / "lib").items()}
    registers = ptxas_registers({"kernel": build.CSRC, **trees}, out_root / "cubin")
    print(f"registers a thread: {json.dumps(registers)}", flush=True)
    bufs = buffers(torch, args, dev, gen)
    sb, pb = bufs["sssp"], bufs["packed"]
    result = {"device": torch.cuda.get_device_name(0), "card": card, "rounds": args.rounds,
              "reps": args.reps, "calls_a_graph": CALLS,
              "variants": VARIANTS if args.variants else {}, "registers": registers,
              "sssp_shape": list(sb["idx"].shape), "sssp_n_local": sb["n_local"],
              "packed_slots": int(pb["val"].shape[0]), "packed_width": pb["kw"]["width"],
              "packed_structural": pb["structural"]}
    if "parent" in others:
        result["parent_bitwise_cases"] = parent_bits(torch, gen, bufs, others["parent"])
    for label, kind, sr, val in cases(torch, gen, bufs):
        kernel, want, (lib_name, library), other, n_valid = calls_of(torch, bufs, kind, sr,
                                                                     val, others)
        got = kernel()
        ok = (torch.allclose(got, want, rtol=1e-5, atol=1e-6) if sr == "plus_times"
              else torch.equal(got, want))
        if not ok:
            raise SystemExit(f"{label}: the kernel disagrees with its plain version")
        for tag, fn in other.items():
            if not torch.equal(fn(), got):
                raise SystemExit(f"{label}: {tag} differs from this tree's kernel")
        eager = {"kernel": event_ms(torch, kernel, 20), lib_name: event_ms(torch, library, 20)}
        sides = [("kernel", kernel), (lib_name, library), *other.items()]
        replays = [(name, graphed(torch, fn, CALLS)) for name, fn in sides]
        got_ms = alternate(torch, replays, args.rounds, args.reps, None)
        per_call = {name: [ms / CALLS for ms in got_ms[name]] for name, _ in sides}
        for r in range(args.rounds):
            print(f"{label} round {r}: " + ", ".join(
                f"{name} {per_call[name][r]:.5f} ms" for name, _ in sides), flush=True)
        result[label] = {
            "kernel": NAMES[0] if kind == "sparse" else NAMES[1], "semiring": sr,
            "valid_slots": n_valid,
            **{f"{side}_ms": per_call[side] for side, _ in sides},
            **{f"{side}_ms_median": statistics.median(per_call[side]) for side, _ in sides},
            **{f"{side}_eager_ms": ms for side, ms in eager.items()},
            "kernel_faster_than_library_every_round": all(
                k < x for k, x in zip(per_call["kernel"], per_call[lib_name]))}
        del replays, got, want, kernel, library, other
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
