"""The two Q-wide receive folds (``scatter_combine_multi``,
``packed_scatter_combine_multi``) against their library yardsticks on an
H100, in alternating rounds.

On the RMAT graph of ``chip_smoke.py`` (scale 20, edge factor 16, b = 8)
this prepares the serve's three families -- RWR and SSSP on the sparse
exchange (``PMVServer(strategy='hybrid', theta=3000, scatter='kernel')``)
and RWR on the packed exchange (``exchange='packed'``) -- and builds one
batched step's receive buffers from a state [b, n_local, 64] drawn from
``--seed`` (uniform for RWR; uniform with a fifth of the entries infinite
for SSSP): each sparse family's compacted (idx, val), as
``sparse_exchange.compact_partials(batched=True)`` gives them, and the
packed family's words and gathered payload.  Then it times with CUDA
events, in rounds where the sides take turns to go first:

- ``scatter_combine_multi`` plus_times on the RWR buffers against
  ``index_add_`` at the valid slots;
- ``scatter_combine_multi`` min_plus on the SSSP buffers against
  ``index_reduce_('amin')`` at the valid slots;
- ``packed_scatter_combine_multi`` plus_times on the packed buffers against
  ``index_add_`` of the structural slots at pre-decoded ids.

Each kernel is first held against its plain version (plus_times rtol 1e-5,
the others exactly).  With ``--parent DIR`` (a ``kernels/csrc`` directory
of another checkout) the two entry points are also built from DIR, timed as
a further side, and held to the same bits as this tree's kernels on every
family's buffers for 4 semirings and int32 min_src at Q in {5, 64, 67}
(values drawn at each family's slots).  With ``--variants`` the two are
also built from copies of this tree's csrc that differ only in
``scatter_tile.cuh``'s tile constants (the shared tile's bytes, the blocks
an SM that ``__launch_bounds__`` asks for, which caps the registers, and
the slots a thread loads per chunk; ``VARIANTS`` below), each held to the
same bits as this tree's kernel on the family's buffers and timed as a
side of its own.  Run on a machine with one CUDA card, from the repository
root:

    python3 tools/bench_scatter_multi.py [--scale 20] [--rounds 6] [--reps 20]
                                         [--parent DIR] [--variants]

Prints the card's name and power limit, one line a round, then one JSON
object.  Exits 1 without a card, and on a kernel that disagrees.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import sys
import warnings
from pathlib import Path

from benchlib import alternate, card_line, load_entries

NAMES = ("scatter_combine_multi", "packed_scatter_combine_multi")
SWEEP = (("plus_times", "float32"), ("min_plus", "float32"), ("max_plus", "float32"),
         ("min_src", "float32"), ("min_src", "int32"))
# scatter_tile.cuh's constants in each variant: the shared tile's bytes,
# the blocks an SM (__launch_bounds__' minimum, which caps the registers at
# 65536 / (256 * blocks)) and the slots a thread loads per chunk.  This
# tree's own constants are the side "kernel" and are left out here.
VARIANTS = {
    f"tile{b // 1024}k_sm{m}_items{i}": dict(kTileBytes=b, kTileBlocksPerSm=m, kTileItems=i)
    for b, m, i in ((65536, 3, 8), (65536, 2, 8), (65536, 3, 4), (32768, 3, 8),
                    (49152, 4, 8), (49152, 4, 4), (98304, 2, 8), (32768, 4, 2),
                    (32768, 4, 6), (32768, 3, 4), (32768, 5, 4), (40960, 4, 4),
                    (24576, 4, 4), (16384, 4, 4))}


def load_tree(torch, entries: dict, tag: str) -> dict:
    """The two Q-wide scatter entry points of one built tree, as calls with
    this tree's wrappers' arguments (no launch counts, no checks)."""
    from repro_torch.kernels import _common, build

    def sparse(idx, val, n_local, *, semiring):
        sets, senders, cap, nq = val.shape
        out = torch.empty((sets, n_local, nq), dtype=val.dtype, device=val.device)
        rc = entries[NAMES[0]](idx.data_ptr(), val.data_ptr(), out.data_ptr(), sets, senders,
                               cap, n_local, nq, _common.SEMIRING_ID[semiring],
                               _common.VALUE_TYPE_ID[val.dtype],
                               _common.current_stream(val.device))
        build.check_rc(rc, f"{tag} {NAMES[0]}")
        return out

    def packed(words, val, n_out, *, set_slots, n_local, width, semiring, senders):
        nq = val.shape[1]
        out = torch.empty((n_out, nq), dtype=val.dtype, device=val.device)
        rc = entries[NAMES[1]](words.data_ptr(), val.data_ptr(), out.data_ptr(),
                               val.shape[0] // set_slots, set_slots, senders, n_local, n_out,
                               nq, width, _common.SEMIRING_ID[semiring],
                               _common.VALUE_TYPE_ID[val.dtype],
                               _common.current_stream(val.device))
        build.check_rc(rc, f"{tag} {NAMES[1]}")
        return out
    return {NAMES[0]: sparse, NAMES[1]: packed}


def variant_csrc(out: Path, consts: dict) -> Path:
    """A copy of this tree's csrc in ``out`` with scatter_tile.cuh's
    constants set to ``consts``."""
    from repro_torch.kernels import build

    shutil.copytree(build.CSRC, out, dirs_exist_ok=True)
    hdr = out / "scatter_tile.cuh"
    text = hdr.read_text()
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise SystemExit(f"scatter_tile.cuh has no one 'constexpr int {name} = N;'")
    hdr.write_text(text)
    return out


def random_values(torch, gen, shape, semiring: str, dtype: str):
    """Values of ``dtype`` with a fifth of them the semiring's identity."""
    from repro_torch.kernels._common import identity

    dev = gen.device
    if dtype == "int32":
        x = torch.randint(0, 1000, shape, generator=gen, device=dev, dtype=torch.int32)
    else:
        x = torch.rand(shape, generator=gen, device=dev)
    return x.masked_fill_(torch.rand(shape, generator=gen, device=dev) < 0.2,
                          identity(semiring, x.dtype))


def families(torch, args, dev, gen):
    """The receive buffers of one batched step of each serve family."""
    from repro_torch.core import placement, sparse_exchange
    from repro_torch.exchange import gather_payload
    from repro_torch.graph import rmat
    from repro_torch.serving import PMVServer, Query

    n = 1 << args.scale
    b = 8
    edges = rmat(args.scale, 16 << args.scale, seed=args.seed)
    out = {}
    for label, exchange, query in (("rwr", "sparse", Query("rwr", source=1, c=0.85, tol=1e-6)),
                                   ("sssp", "sparse", Query("sssp", source=1, tol=0.5)),
                                   ("packed_rwr", "packed",
                                    Query("rwr", source=1, c=0.85, tol=1e-6))):
        srv = PMVServer(edges, n, b=b, strategy="hybrid", theta=3000.0, backend="auto",
                        scatter="kernel", exchange=exchange, stream="off", device=dev)
        eng, fspec = srv.engine_for(query)
        matrix, _, _, _, meta = eng.prepare(fspec)
        nl = meta["part"].n_local
        state = torch.rand((b, nl, 64), generator=gen, device=dev)
        if label == "sssp":
            state.masked_fill_(torch.rand(state.shape, generator=gen, device=dev) < 0.2,
                               float("inf"))
        partials = placement._planned_vertical_partials(fspec, matrix["planned_sparse"], state,
                                                        nl)
        if exchange == "sparse":
            idx, val, _, _ = sparse_exchange.compact_partials(fspec, partials, meta["capacity"],
                                                              batched=True)
            out[label] = dict(kind="sparse", n_local=nl,
                              idx=idx.transpose(0, 1).contiguous(),
                              val=val.transpose(0, 1).contiguous(),
                              semiring="plus_times" if label == "rwr" else "min_plus")
        else:
            xp, xchg = meta["cfg"].xplan, matrix["xchg"]
            payload = gather_payload(fspec, partials, xchg["send_rows"])
            out[label] = dict(kind="packed", n_local=nl, words=xchg["recv_words"].reshape(-1),
                              val=payload.transpose(0, 1).contiguous().reshape(-1, 64),
                              kw=dict(set_slots=b * xp.p_dev, n_local=nl, width=xp.width_dev,
                                      senders=b),
                              n_out=b * (nl + 1), semiring="plus_times",
                              structural=int((xchg["recv_rows"] < nl).sum()))
        del partials, matrix, state
        srv.close()
        torch.cuda.empty_cache()
    return out


def sides_of(torch, fam, others):
    """(name, callable) of each side for one family, and its valid slots;
    the kernel is first held against its plain version, and every other
    tree (``others``: {tag: load_tree(...)}) to the kernel's bits."""
    from repro_torch.kernels import scatter_combine as sc
    from repro_torch.kernels.scatter_combine.ref import packed_targets

    sr, val = fam["semiring"], fam["val"]
    nq = val.shape[-1]
    if fam["kind"] == "sparse":
        idx, nl = fam["idx"], fam["n_local"]
        s_ = idx.shape[0]
        kernel = lambda: sc.scatter_combine_gimv_multi(idx, val, nl, semiring=sr)  # noqa: E731
        want = sc.scatter_combine_multi_ref(idx, val, nl, semiring=sr)
        flat = idx.reshape(s_, -1).to(torch.int64)
        keep = (flat < nl).reshape(-1)
        rows = (flat + torch.arange(s_, device=idx.device)[:, None] * nl).reshape(-1)[keep]
        vals = val.reshape(-1, nq)[keep]
        n_rows, n_valid = s_ * nl, int(keep.sum())
        other = {tag: (lambda t=t: t[NAMES[0]](idx, val, nl, semiring=sr))
                 for tag, t in others.items()}
    else:
        words, kw, n_out = fam["words"], fam["kw"], fam["n_out"]
        plain_kw = {k: v for k, v in kw.items() if k != "senders"}
        kernel = lambda: sc.packed_scatter_combine_gimv_multi(  # noqa: E731
            words, val, n_out, semiring=sr, **kw)
        want = sc.packed_scatter_combine_multi_ref(words, val, n_out, semiring=sr, **plain_kw)
        rows = packed_targets(words, val.shape[0], n_out, **plain_kw)
        keep = rows < n_out
        rows, vals = rows[keep], val[keep]
        n_rows, n_valid = n_out, int(keep.sum())
        other = {tag: (lambda t=t: t[NAMES[1]](words, val, n_out, semiring=sr, **kw))
                 for tag, t in others.items()}
    got = kernel()
    ok = (torch.allclose(got.reshape(n_rows, nq), want.reshape(n_rows, nq), rtol=1e-5, atol=1e-6)
          if sr == "plus_times" else torch.equal(got, want))
    if not ok:
        raise SystemExit(f"{fam['kind']} {sr}: the kernel disagrees with its plain version")
    for tag, fn in other.items():
        if not torch.equal(fn(), got):
            raise SystemExit(f"{fam['kind']} {sr}: {tag} differs from this tree's kernel")
    if sr == "plus_times":
        base = torch.zeros((n_rows, nq), device=val.device)
        library = lambda: base.clone().index_add_(0, rows, vals)  # noqa: E731
        lib_name = "index_add_"
    else:
        base = torch.full((n_rows, nq), float("inf"), device=val.device)
        library = lambda: base.clone().index_reduce_(0, rows, vals, "amin")  # noqa: E731
        lib_name = "index_reduce_"
    return [("kernel", kernel), (lib_name, library), *other.items()], n_valid


def parent_bits(torch, gen, fam, parent) -> int:
    """This tree's kernel against the parent's on the family's slots, for 4
    semirings and int32 min_src at Q in {5, 64, 67}; the count of cases."""
    from repro_torch.kernels import scatter_combine as sc

    cases = 0
    lead = tuple(fam["val"].shape[:-1])
    for nq in (5, 64, 67):
        for sr, dt in SWEEP:
            x = random_values(torch, gen, lead + (nq,), sr, dt)
            if fam["kind"] == "sparse":
                args = (fam["idx"], x, fam["n_local"])
                got = sc.scatter_combine_gimv_multi(*args, semiring=sr)
                want = parent[NAMES[0]](*args, semiring=sr)
            else:
                args = (fam["words"], x, fam["n_out"])
                got = sc.packed_scatter_combine_gimv_multi(*args, semiring=sr, **fam["kw"])
                want = parent[NAMES[1]](*args, semiring=sr, **fam["kw"])
            if not torch.equal(got, want):
                raise SystemExit(f"{fam['kind']} {sr} {dt} Q={nq}: differs from the parent")
            cases += 1
            del x, got, want
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a kernels/csrc directory whose two Q-wide scatter kernels are timed "
                         "beside these")
    ap.add_argument("--variants", action="store_true",
                    help="also time the tile-constant variants of VARIANTS")
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
    out_root = build.build_dir() / "bench_scatter_multi"
    trees = {"parent": args.parent} if args.parent else {}
    if args.variants:
        trees.update({tag: variant_csrc(out_root / "src" / tag, consts)
                      for tag, consts in VARIANTS.items()})
    others = {tag: load_tree(torch, entries, tag)
              for tag, entries in load_entries(trees, NAMES, out_root / "lib").items()}
    fams = families(torch, args, dev, gen)
    result = {"device": torch.cuda.get_device_name(0), "card": card, "rounds": args.rounds,
              "reps": args.reps, "variants": VARIANTS if args.variants else {}}
    for label, fam in fams.items():
        if "parent" in others:
            result[f"{label}_parent_bitwise_cases"] = parent_bits(torch, gen, fam,
                                                                  others["parent"])
        sides, n_valid = sides_of(torch, fam, others)
        got = alternate(torch, sides, args.rounds, args.reps, f"{label} {fam['semiring']}")
        lib = sides[1][0]
        result[label] = {
            "kernel": NAMES[0] if fam["kind"] == "sparse" else NAMES[1],
            "semiring": fam["semiring"], "shape": list(fam["val"].shape),
            "n_local": fam["n_local"], "valid_slots": n_valid,
            **{f"{side}_ms": got[side] for side, _ in sides},
            **{f"{side}_ms_median": statistics.median(got[side]) for side, _ in sides},
            "kernel_faster_than_library_every_round": all(
                k < x for k, x in zip(got["kernel"], got[lib]))}
        del sides
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
