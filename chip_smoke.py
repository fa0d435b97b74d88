#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PMV (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--scale 20] [--seed 0] [--verbose-build]

Phases, each printed as it ends; any failure exits non-zero:

1. build   -- compile the three CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. graph   -- RMAT(scale, 16 << scale) with the paper's a,b,c,d and b = 8 workers.
3. runs    -- three ``PMVEngine(backend='auto', device='cuda').run`` solves:
              PageRank (strategy='selective'), SSSP from vertex 0
              (strategy='vertical', scatter='kernel') and connected components
              (strategy='hybrid', theta=3000, symmetrized edges).  The launch
              counters are zeroed just before each run and read just after;
              every kernel the run takes must have launched.  Each result is
              held against scipy (PageRank: a CSR power iteration of the same
              formula and iteration count, rtol 1e-4; SSSP and CC: exact).
4. kernels -- after each run, the kernels it launched are called on the
              run's own inputs (every ELL bucket; the exchange buffers; the
              dense region) and held against their plain PyTorch versions
              for all four semirings (plus int32 for min_src): exact for
              min_plus / max_plus / min_src, rtol 1e-5 / atol 1e-6 for
              plus_times (the summation order differs; atol scales down with
              data below 1).  Every ELL bucket is also run on a uniform
              random vector.  These launches are
              outside the counted runs.  Kernel, plain-version and library
              times are CUDA-event means.
   Each run is also profiled for 3 more iterations (torch.profiler): device
   time per iteration by kernel, host wall per iteration, idle share.
5. summary -- the card, a ``{"kernels": [...]}`` line, and last the device line.

Exits non-zero without a result when no CUDA device is present, or when the
repository's ``src/repro_torch`` is not beside this file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

# H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 on CUDA cores.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

KERNEL_SOURCES = {
    "ell_gimv": ("src/repro_torch/kernels/csrc/ell_gimv.cu",
                 "src/repro/kernels/ell_spmv/ell_spmv.py:59"),
    "dense_gimv": ("src/repro_torch/kernels/csrc/dense_gimv.cu",
                   "src/repro/kernels/block_gimv/block_gimv.py:152"),
    "scatter_combine": ("src/repro_torch/kernels/csrc/scatter_combine.cu",
                        "src/repro/kernels/scatter_combine/scatter_combine.py:61"),
}


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired) as e:
        line = f"nvidia-smi failed: {e}"
    return line or "nvidia-smi printed nothing"


# ---------------------------------------------------------------------------
# timing


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of ``fn`` in ms over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


KERNEL_CLASSES = (("ell_gimv_kernel", "ell_gimv"), ("dense_gimv_kernel", "dense_gimv"),
                  ("scatter_pass", "scatter_combine"), ("fill_identity", "scatter_combine"))


def device_breakdown(torch, run, iters: int) -> dict:
    """Profile ``run()`` (``iters`` solver iterations) with torch.profiler:
    device time per iteration of this package's kernels and of every other
    device op, the host wall per iteration, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace can miss the window's first device activity: make it this
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per: dict[str, float] = {}
    launches: dict[str, int] = {}
    top: dict[str, float] = {}
    host: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host[evt.key[:50]] = evt.self_cpu_time_total / 1e3 / iters
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        cls = next((c for key, c in KERNEL_CLASSES if key in evt.key), "other")
        per[cls] = per.get(cls, 0.0) + us / 1e3 / iters
        launches[cls] = launches.get(cls, 0) + evt.count
        if cls == "other":
            top[evt.key[:70]] = top.get(evt.key[:70], 0.0) + us / 1e3 / iters
    busy = sum(per.values())

    def head(d, k):
        return dict(sorted(d.items(), key=lambda kv: -kv[1])[:k])

    return {"wall_ms_per_iter": wall_ms / iters, "device_ms_per_iter": busy,
            "idle_share": max(0.0, 1.0 - busy * iters / wall_ms), "by_kernel_ms": per,
            "device_launches": launches, "top_other_device_ms": head(top, 5),
            "top_host_self_ms": head(host, 8)}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, semiring: str, what: str) -> float:
    """Hold a kernel result against its plain version; returns max |err|.
    plus_times: rtol 1e-5 and atol 1e-6, the atol scaled down with the data
    where its largest value is below 1 (PageRank values are ~1e-6)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SmokeError(f"{what}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
                         f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    both_inf = torch.isinf(g) & torch.isinf(w) & (torch.sign(g) == torch.sign(w))
    diff = torch.where(both_inf, torch.zeros_like(g), (g - w).abs())
    err = float(diff.max()) if diff.numel() else 0.0
    if semiring == "plus_times":
        scale = float(w.abs().max()) if w.numel() else 1.0
        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6 * min(1.0, scale))
    else:
        ok = torch.equal(got, want)
    if not ok:
        raise SmokeError(f"{what}: kernel disagrees with its plain version (max |err| {err})")
    return err


# ---------------------------------------------------------------------------
# scipy references


def pagerank_ref(np, sp, edges, n, iters, d=0.85):
    src, dst = edges[:, 0], edges[:, 1]
    out = np.bincount(src, minlength=n)
    w = 1.0 / np.maximum(out, 1)[src]
    a = sp.csr_matrix((w, (dst, src)), shape=(n, n))
    v = np.full(n, 1.0 / n)
    for _ in range(iters):
        v = (1.0 - d) / n + d * (a @ v)
    return v


def sssp_ref(np, sp, csgraph, edges, n, source):
    a = sp.csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n))
    return csgraph.shortest_path(a, directed=True, unweighted=True, indices=source)


def cc_ref(np, sp, csgraph, edges, n):
    a = sp.csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])), shape=(n, n))
    _, labels = csgraph.connected_components(a, directed=False)
    mins = np.full(labels.max() + 1, n, dtype=np.int64)
    np.minimum.at(mins, labels, np.arange(n))
    return mins[labels].astype(np.int32)


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale: n = 2**scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v report")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    from repro_torch import kernels
    from repro_torch.core import (PMVEngine, connected_components, pagerank,
                                  placement, sparse_exchange, sssp)
    from repro_torch.graph import rmat, symmetrize_edges
    from repro_torch.kernels import block_gimv, ell_spmv, scatter_combine
    from repro_torch.kernels.build import build_all

    warnings.filterwarnings("ignore", message="Sparse")   # the CSR yardstick's beta notes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    build_all(verbose=args.verbose_build)
    log(f"build: {time.perf_counter() - t:.2f} s for {len(KERNEL_SOURCES)} kernels")

    n = 1 << args.scale
    b = 8
    t = time.perf_counter()
    edges = rmat(args.scale, 16 << args.scale, seed=args.seed)
    sym = symmetrize_edges(edges)
    log(f"graph: rmat scale {args.scale}: n={n} edges={len(edges)} symmetrized={len(sym)} "
        f"({time.perf_counter() - t:.1f} s)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rows: dict[str, dict] = {}
    failures: list[str] = []

    def rand_v(size, dtype):
        if dtype == torch.int32:
            return torch.randint(0, n, (size,), generator=gen, device=dev, dtype=torch.int32)
        return torch.rand(size, generator=gen, device=dev)

    def drive(label, eng, spec, *, max_iters, tol, expect):
        _, _, _, _, meta = eng.prepare(spec)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = eng.run(spec, max_iters=max_iters, tol=tol)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        walls = [1e3 * r["wall_s"] for r in res.per_iter]
        log(f"run {label}: strategy={res.strategy} backend={meta['backend']} "
            f"iterations={res.iterations} converged={res.converged} "
            f"prepare_s={meta['prepare_s']:.2f} first_iter_ms={walls[0]:.3f} "
            f"median_later_iter_ms={np.median(walls[1:] or walls):.3f} "
            f"mean_iter_ms={np.mean(walls):.3f} peak_gib={peak:.2f} "
            f"launches={json.dumps(counts)}")
        if meta["backend"] != "planned":
            raise SmokeError(f"{label}: backend resolved to {meta['backend']!r}")
        prof = device_breakdown(torch, lambda: eng.run(spec, max_iters=3, tol=-1.0), 3)
        log(f"profile {label}: {json.dumps(prof)}")
        for name in expect:
            if counts[name] == 0:
                raise SmokeError(f"{label}: kernel {name} never launched on the main path")
            rows.setdefault(name, {"launches": 0})["launches"] += counts[name]
        return res, meta

    def ell_sweep(label, fp, v_flat, main_semiring, has_w_semirings):
        """Every bucket with the run's semiring, on the run's own vector and
        on a uniform random one; the widest bucket across all four semirings
        (+ int32 min_src)."""
        n_src = v_flat.shape[0]
        v_rand = rand_v(n_src, v_flat.dtype)
        for i, bk in enumerate(fp.buckets):
            w = bk.w if main_semiring in has_w_semirings else None
            for which, v in (("run v", v_flat), ("random v", v_rand)):
                got = ell_spmv.ell_gimv(bk.cols, w, v, semiring=main_semiring)
                want = ell_spmv.ell_gimv_ref(bk.cols, w, v, semiring=main_semiring)
                compare(torch, got, want, main_semiring,
                        f"{label} ell bucket {i} {tuple(bk.cols.shape)} {which}")
        big = max(fp.buckets, key=lambda x: x.cols.numel())
        for semiring, dtype in (("plus_times", torch.float32), ("min_plus", torch.float32),
                                ("max_plus", torch.float32), ("min_src", torch.float32),
                                ("min_src", torch.int32)):
            v = rand_v(n_src, dtype)
            got = ell_spmv.ell_gimv(big.cols, big.w, v, semiring=semiring)
            want = ell_spmv.ell_gimv_ref(big.cols, big.w, v, semiring=semiring)
            compare(torch, got, want, semiring, f"{label} ell {semiring} {dtype} {tuple(big.cols.shape)}")
        log(f"kernels {label}: ell_gimv matches its plain version on {len(fp.buckets)} buckets "
            "(run and random v) and 4 semirings")
        return big

    # -- run 1: PageRank, selective (horizontal at this density) ----------------
    eng = PMVEngine(edges, n, b=b, strategy="selective", backend="auto", device=dev)
    spec = pagerank(n)
    res, meta = drive("pagerank/selective", eng, spec, max_iters=100, tol=1e-6,
                      expect=("ell_gimv",))
    want = pagerank_ref(np, sp, edges, n, res.iterations)
    ok = np.allclose(res.v, want, rtol=1e-4, atol=1e-12)
    rel = float(np.max(np.abs(res.v - want) / np.maximum(want, 1e-30)))
    log(f"check pagerank vs scipy power iteration ({res.iterations} iters): "
        f"max rel err {rel:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("pagerank disagrees with scipy")
    fp = eng.prepare(spec)[0]["planned"]
    part = meta["part"]
    v_flat = torch.from_numpy(part.to_blocked(res.v.astype(np.float32)).reshape(-1).copy()).to(dev)
    big = ell_sweep("pagerank", fp, v_flat, "plus_times", ("plus_times", "min_plus", "max_plus"))
    nnz = int((big.cols >= 0).sum())
    r_, d_ = big.cols.shape
    ms = time_ms(torch, lambda: ell_spmv.ell_gimv(big.cols, big.w, v_flat, semiring="plus_times"), 20)
    plain_ms = time_ms(torch, lambda: ell_spmv.ell_gimv_ref(big.cols, big.w, v_flat,
                                                            semiring="plus_times"), 5, warmup=1)
    got = ell_spmv.ell_gimv(big.cols, big.w, v_flat, semiring="plus_times")
    err = compare(torch, got, ell_spmv.ell_gimv_ref(big.cols, big.w, v_flat, semiring="plus_times"),
                  "plus_times", "ell timed bucket")
    valid = big.cols >= 0
    deg = valid.sum(dim=1)
    # yardstick only: a CSR matvec over the bucket's valid slots
    crow = torch.zeros(r_ + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(deg, 0)
    lib_ms = None
    try:
        csr = torch.sparse_csr_tensor(crow, big.cols[valid].to(torch.int64), big.w[valid],
                                      size=(r_, v_flat.shape[0]))
        lib_out = torch.mv(csr, v_flat)
    except (RuntimeError, NotImplementedError) as e:  # the library call only
        log(f"library yardstick for ell_gimv unavailable: {e}")
    else:
        compare(torch, got, lib_out, "plus_times", "ell vs CSR matvec")
        lib_ms = time_ms(torch, lambda: torch.mv(csr, v_flat), 20)
        del csr, lib_out
    # the layout bound reads every padded col; the valid-slot bound is what a
    # kernel that stops at a row's first all-pad 32-slot chunk would read
    nbytes = r_ * d_ * 4 + nnz * 4 + min(nnz, v_flat.shape[0]) * 4 + r_ * 4
    b_ms, b_by = bound(nbytes, 2 * nnz)
    chunks = int(torch.clamp((deg + 31) // 32, min=1).sum())
    valid_b_ms, _ = bound(chunks * 128 + nnz * 4 + min(nnz, v_flat.shape[0]) * 4 + r_ * 4,
                          2 * nnz)
    del valid, deg, crow, got
    rows["ell_gimv"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, valid_slot_bound_ms=valid_b_ms, semiring="plus_times",
        shape=[r_, d_], occupancy=nnz / (r_ * d_))
    lib_txt = "unavailable" if lib_ms is None else f"{lib_ms:.3f} ms"
    log(f"time ell_gimv plus_times {[r_, d_]} occupancy {nnz / (r_ * d_):.4f}: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, CSR matvec {lib_txt}, "
        f"bound {b_ms:.3f} ms (layout), {valid_b_ms:.4f} ms (valid slots)")
    occ = {f"{bk.cols.shape[1]}": [int(bk.cols.shape[0]), float((bk.cols >= 0).float().mean())]
           for bk in fp.buckets}
    log(f"buckets pagerank (width: [rows, occupancy]): {json.dumps(occ)}")
    del eng, fp, big, v_flat
    torch.cuda.empty_cache()

    # -- run 2: SSSP, vertical with the scatter-combine kernel -----------------
    eng = PMVEngine(edges, n, b=b, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device=dev)
    spec = sssp(0)
    res, meta = drive("sssp/vertical", eng, spec, max_iters=100, tol=0.5,
                      expect=("ell_gimv", "scatter_combine"))
    want = sssp_ref(np, sp, csgraph, edges, n, 0)
    ok = res.converged and np.array_equal(res.v.astype(np.float64), want)
    log(f"check sssp vs scipy shortest_path: reached {int(np.isfinite(want).sum())} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("sssp disagrees with scipy")
    fp = eng.prepare(spec)[0]["planned"]
    part = meta["part"]
    nl = part.n_local
    v_local = torch.from_numpy(part.to_blocked(res.v.astype(np.float32)).copy()).to(dev)
    # one step's exchange buffers from the state one iteration before the end
    v_prev = torch.where(torch.rand(v_local.shape, generator=gen, device=dev) < 0.5,
                         v_local, torch.full_like(v_local, float("inf")))
    ell_sweep("sssp", fp, v_prev.reshape(-1), "min_plus", ("plus_times", "min_plus", "max_plus"))
    partials = placement._planned_vertical_partials(spec, fp, v_prev, nl)
    idx, val, _, _ = sparse_exchange.compact_partials(spec, partials, meta["capacity"])
    idx_x, val_x = idx.transpose(0, 1).contiguous(), val.transpose(0, 1).contiguous()
    del partials
    errs = []
    for semiring, vv in (("min_plus", val_x), ("plus_times", torch.rand(val_x.shape, generator=gen, device=dev)),
                         ("max_plus", torch.rand(val_x.shape, generator=gen, device=dev)),
                         ("min_src", torch.rand(val_x.shape, generator=gen, device=dev)),
                         ("min_src", torch.randint(0, n, val_x.shape, generator=gen, device=dev,
                                                   dtype=torch.int32))):
        got = scatter_combine.scatter_combine_gimv(idx_x, vv, nl, semiring=semiring)
        wnt = scatter_combine.scatter_combine_ref(idx_x, vv, nl, semiring=semiring)
        errs.append(compare(torch, got, wnt, semiring,
                            f"scatter {semiring} {vv.dtype} {tuple(idx_x.shape)}"))
    # plus_times is the same bits from run to run (fixed sender order)
    rv = torch.rand(val_x.shape, generator=gen, device=dev)
    r1 = scatter_combine.scatter_combine_gimv(idx_x, rv, nl, semiring="plus_times")
    r2 = scatter_combine.scatter_combine_gimv(idx_x, rv, nl, semiring="plus_times")
    if not torch.equal(r1, r2):
        raise SmokeError("scatter_combine plus_times is not reproducible run to run")
    log(f"kernels sssp: scatter_combine matches its plain version at {list(idx_x.shape)} "
        "for 4 semirings; plus_times bitwise reproducible")
    s_, b_, cap = idx_x.shape
    ms = time_ms(torch, lambda: scatter_combine.scatter_combine_gimv(idx_x, val_x, nl, semiring="min_plus"), 20)
    plain_ms = time_ms(torch, lambda: scatter_combine.scatter_combine_ref(idx_x, val_x, nl,
                                                                          semiring="min_plus"), 20)
    flat = idx_x.reshape(s_, -1).to(torch.int64)
    flat = torch.where(flat < nl, flat, nl) + torch.arange(s_, device=dev)[:, None] * (nl + 1)
    flat, fval = flat.reshape(-1), val_x.reshape(-1)
    base = torch.full((s_ * (nl + 1),), float("inf"), device=dev)
    lib_ms = time_ms(torch, lambda: base.clone().scatter_reduce_(0, flat, fval, reduce="amin"), 20)
    n_valid = int((idx_x < nl).sum())
    nbytes = s_ * b_ * cap * 4 + n_valid * 4 + s_ * nl * 4
    b_ms, b_by = bound(nbytes, n_valid)
    rows["scatter_combine"].update(
        max_abs_err=errs[0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, semiring="min_plus", shape=[s_, b_, cap], n_local=nl)
    log(f"time scatter_combine min_plus {[s_, b_, cap]} n_local {nl} valid {n_valid}: "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, scatter_reduce {lib_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms")
    del eng, fp, idx, val, idx_x, val_x, flat, fval, base
    torch.cuda.empty_cache()

    # -- run 3: connected components, hybrid theta=3000 -------------------------
    eng = PMVEngine(sym, n, b=b, strategy="hybrid", theta=3000.0, backend="auto",
                    stream="off", device=dev)
    spec = connected_components()
    res, meta = drive("cc/hybrid", eng, spec, max_iters=100, tol=0.5,
                      expect=("ell_gimv", "dense_gimv"))
    hm = meta["hm"]
    log(f"hybrid: theta={meta['theta']} dense vertices={meta['n_dense']} d_cap={hm.dense.d_cap} "
        f"dense edges={hm.dense_nnz} sparse edges={hm.sparse_nnz}")
    want = cc_ref(np, sp, csgraph, sym, n)
    ok = res.converged and np.array_equal(res.v, want)
    log(f"check cc vs scipy connected_components: {len(np.unique(want))} components "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("cc disagrees with scipy")
    matrix = eng.prepare(spec)[0]
    fp, dm = matrix["planned_sparse"], matrix["dense_matrix"]
    part = meta["part"]
    v_local = torch.from_numpy(part.to_blocked(res.v).copy()).to(dev)
    ell_sweep("cc", fp, v_local.reshape(-1), "min_src", ())
    v_d = torch.gather(v_local, 1, matrix["dense_region"].gather_idx).reshape(-1).contiguous()
    for semiring, vv in (("min_src", v_d), ("min_src", v_d.float()),
                         ("plus_times", rand_v(v_d.shape[0], torch.float32)),
                         ("min_plus", rand_v(v_d.shape[0], torch.float32)),
                         ("max_plus", rand_v(v_d.shape[0], torch.float32))):
        got = block_gimv.dense_gimv(dm, vv, semiring=semiring)
        wnt = block_gimv.dense_gimv_ref(dm, vv, semiring=semiring)
        compare(torch, got, wnt, semiring, f"dense {semiring} {vv.dtype} {tuple(dm.shape)}")
    log(f"kernels cc: dense_gimv matches its plain version at {list(dm.shape)} for 4 semirings")
    m_, k_ = dm.shape
    vf = rand_v(k_, torch.float32)
    ms = time_ms(torch, lambda: block_gimv.dense_gimv(dm, vf, semiring="plus_times"), 20)
    plain_ms = time_ms(torch, lambda: block_gimv.dense_gimv_ref(dm, vf, semiring="plus_times"), 5,
                       warmup=1)
    lib_ms = time_ms(torch, lambda: torch.mv(dm, vf), 20)
    ms_src = time_ms(torch, lambda: block_gimv.dense_gimv(dm, v_d, semiring="min_src"), 20)
    err = compare(torch, block_gimv.dense_gimv(dm, vf, semiring="plus_times"),
                  block_gimv.dense_gimv_ref(dm, vf, semiring="plus_times"), "plus_times",
                  "dense timed call")
    compare(torch, block_gimv.dense_gimv(dm, vf, semiring="plus_times"), torch.mv(dm, vf),
            "plus_times", "dense vs torch.mv")
    b_ms, b_by = bound(m_ * k_ * 4 + k_ * 4 + m_ * 4, 2 * m_ * k_)
    rows["dense_gimv"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, semiring="plus_times", shape=[m_, k_], min_src_int32_ms=ms_src)
    log(f"time dense_gimv {[m_, k_]}: plus_times kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"torch.mv {lib_ms:.3f} ms, bound {b_ms:.3f} ms; min_src int32 kernel {ms_src:.3f} ms")
    del eng, matrix, fp, dm
    torch.cuda.empty_cache()

    if failures:
        raise SmokeError("; ".join(failures))
    out = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        row = rows[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    **row})
    log(f"card: {card}")
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
