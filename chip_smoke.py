#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PMV (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--scale 20] [--seed 0] [--verbose-build]

Phases, each printed as it ends; any failure exits non-zero:

1. build   -- compile the eight CUDA kernels from ``src/repro_torch/kernels/csrc``
              (``ell_gimv``, ``dense_gimv``, ``scatter_combine``, their Q-wide
              forms ``ell_gimv_multi``, ``dense_gimv_multi``,
              ``scatter_combine_multi``, and the packed exchange's
              ``packed_scatter_combine`` / ``packed_scatter_combine_multi``),
              one ``nvcc`` per source, in parallel.
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
              data below 1), which must also give the same bits twice.
              Every ELL bucket is also run on a uniform random vector.
              These launches are outside the counted runs.  Kernel,
              plain-version and library times are CUDA-event means.  The
              PageRank run times ``ell_gimv`` on every bucket of one
              iteration ("bucket" lines: shape, occupancy, longest row,
              kernel and CSR ``torch.mv`` ms, the valid-slot and layout
              bounds; first asserting every row left-packed, the ELL
              kernels' precondition) and prints their sum.
   Each run is also profiled for 3 more iterations (torch.profiler): device
   time per iteration by kernel, host wall per iteration, idle share.
5. serve   -- ``PMVServer(strategy='hybrid', theta=3000, backend='auto',
              scatter='kernel', device='cuda')`` on the directed graph of
              phase 2 answers 96 RWR (c=0.85, tol 1e-6) and 96 SSSP (tol 0.5)
              queries, interleaved: each family fills one 64-wide batch and
              admits 32 queries mid-batch.  Checks: every query retires
              completed and converged; 8 RWR answers equal a scipy power
              iteration of their own iteration count (rtol 1e-4), 16 SSSP
              answers scipy's shortest paths exactly, 4 per family the
              single-query ``PMVEngine.run`` on the family's own engine (SSSP
              exactly; RWR for the served step count, rtol 1e-4); the
              three Q-wide kernels launched and the single-vector ones did
              not.  Then the Q-wide kernels are held against their plain
              versions at the run's shapes (every ELL bucket on the served
              state and a random [N, 64] block, the dense region, the
              exchange buffers; 4 semirings + int32 min_src at Q = 64 and 5,
              every ELL bucket; the scatter also at Q = 67 and, on every
              case, bitwise against a plain fold in sender order, the order
              of the one-pass-per-sender kernel it replaced), timed against
              their plain versions and a library yardstick (ELL: every
              bucket of the RWR family at Q = 64, as for PageRank, against
              CSR ``torch.sparse.mm``; dense: plus_times on the tensor cores
              (3xTF32) must give the same bits twice and is printed in
              TFLOP/s beside its byte, FP32 and 3xTF32 operation bounds,
              min_plus beside its two-instructions-per-cell bound; scatter:
              min_plus on the SSSP buffers against ``index_reduce_`` and
              plus_times on the RWR buffers against ``index_add_``, both at
              the valid slots, and profiled: one device launch per call),
              and 3 batched iterations per family are profiled.  Prints
              queries/s, latency p50/p99, batched-iteration ms and peak memory.
6. packed  -- the packed exchange (``exchange='packed'``, ids decoded in the
              kernel).  Run: PageRank, strategy='vertical', scatter='kernel',
              delta_eps=0.0 (the packed scatter kernel; held against the
              scipy power iteration at rtol 1e-4; prints the ExchangePlan, the
              per-iteration delta rows and the packed wire bytes against the
              padded stream's).  Serve: ``PMVServer(strategy='hybrid',
              theta=3000, scatter='kernel', exchange='packed')`` answers the
              96 RWR queries of phase 5 (the Q-wide packed kernel), each
              answer and iteration count bitwise phase 5's.  Kernels, outside
              the counted runs: both ELL kernels on every bucket of the two
              packed runs, as in phases 4 and 5; both packed kernels against
              their plain versions on the runs' own buffers (4 semirings +
              int32 min_src; Q = 64, 5 and 67 for kernel 8, which is also
              held bitwise to the sender-order fold), bitwise against the sparse
              kernels fed the compacted buffers of the same partials, at
              synthetic widths 4, 8, 16 and 32 bits (n_local 15, 255, 65535,
              131072; Q = 64 and 67), and plus_times the same bits twice;
              timed against their plain versions and ``index_add_`` on
              pre-decoded ids, and profiled: device launches and device ms
              per call (each must make exactly one launch per call).
7. summary -- the card, a ``{"kernels": [...]}`` line (eight kernels), and last
              the device line.

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

# H100 SXM data sheet: 3.35 TB/s HBM3, 67 TFLOP/s FP32 on CUDA cores (33.5e12
# lane instructions/s: an FMA counts two operations), 495 TFLOP/s TF32 on
# the tensor cores (dense).
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
H100_TF32_OPS_PER_S = 495e12

KERNEL_SOURCES = {
    "ell_gimv": ("src/repro_torch/kernels/csrc/ell_gimv.cu",
                 "src/repro/kernels/ell_spmv/ell_spmv.py:59"),
    "dense_gimv": ("src/repro_torch/kernels/csrc/dense_gimv.cu",
                   "src/repro/kernels/block_gimv/block_gimv.py:152"),
    "scatter_combine": ("src/repro_torch/kernels/csrc/scatter_combine.cu",
                        "src/repro/kernels/scatter_combine/scatter_combine.py:61"),
    "ell_gimv_multi": ("src/repro_torch/kernels/csrc/ell_gimv_multi.cu",
                       "src/repro/kernels/ell_spmv/ell_spmv.py:135"),
    "dense_gimv_multi": ("src/repro_torch/kernels/csrc/dense_gimv_multi.cu",
                         "src/repro/kernels/block_gimv/block_gimv.py:111"),
    "scatter_combine_multi": ("src/repro_torch/kernels/csrc/scatter_combine_multi.cu",
                              "src/repro/kernels/scatter_combine/scatter_combine.py:302"),
    "packed_scatter_combine": ("src/repro_torch/kernels/csrc/packed_scatter_combine.cu",
                               "src/repro/kernels/scatter_combine/scatter_combine.py:153"),
    "packed_scatter_combine_multi": (
        "src/repro_torch/kernels/csrc/packed_scatter_combine_multi.cu",
        "src/repro/kernels/scatter_combine/scatter_combine.py:230"),
}
SINGLE = ("ell_gimv", "dense_gimv", "scatter_combine", "packed_scatter_combine")
MULTI = ("ell_gimv_multi", "dense_gimv_multi", "scatter_combine_multi")


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


# first match wins: the packed kernels' names contain the sparse ones'
KERNEL_CLASSES = (("packed_scatter_multi_tile", "packed_scatter_combine_multi"),
                  ("packed_scatter_tile", "packed_scatter_combine"),
                  ("ell_gimv_kernel", "ell_gimv"), ("ell_gimv_wide_kernel", "ell_gimv"),
                  ("dense_gimv_kernel", "dense_gimv"), ("scatter_pass", "scatter_combine"),
                  ("ell_gimv_multi_kernel", "ell_gimv_multi"),
                  ("ell_gimv_multi_wide_kernel", "ell_gimv_multi"),
                  ("ell_gimv_multi_half_kernel", "ell_gimv_multi"),
                  ("dense_gimv_multi_kernel", "dense_gimv_multi"),
                  ("dense_gimv_multi_tf32x3", "dense_gimv_multi"),
                  ("scatter_multi_tile", "scatter_combine_multi"),
                  ("fill_identity", "scatter_combine"))


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
        # late in a long process the trace drops device events near the
        # window's end (a short window's all of them): keep it open past them
        time.sleep(0.5)
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
        cls = kernel_class(evt.key)
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


def kernel_class(key: str) -> str:
    return next((c for k, c in KERNEL_CLASSES if k in key), "other")


def profiled_calls(torch, fn, cls: str, calls: int = 20) -> tuple[float, float, dict]:
    """Device launches and device ms per call of ``fn`` for the kernel class
    ``cls`` (or of every device op when ``cls`` is "all"), read from
    :func:`device_breakdown` over ``calls`` calls; also its launches by
    class.  The trace can drop events but never adds one, so of up to three
    windows the one that caught the most launches is read."""
    best = None
    for _ in range(3):
        prof = device_breakdown(torch, lambda: [fn() for _ in range(calls)], calls)
        launches = prof["device_launches"]
        n = sum(launches.values()) if cls == "all" else launches.get(cls, 0)
        if best is None or n > best[0]:
            best = (n, prof)
        if cls != "all" and n == calls:
            break
    n, prof = best
    dev_ms = prof["device_ms_per_iter"] if cls == "all" else prof["by_kernel_ms"].get(cls, 0.0)
    return n / calls, dev_ms, prof["device_launches"]


def percentile(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ell_bucket_times(torch, label: str, buckets, v, row: dict, reps: int = 20) -> list[dict]:
    """Time the ELL kernel (``ell_gimv`` for v [N], ``ell_gimv_multi`` for
    v [N, Q]) on every bucket of one iteration with plus_times, beside CSR
    ``torch.mv`` / ``torch.sparse.mm`` over the bucket's valid slots and two
    bounds: the layout bound reads every padded col; the valid-slot bound is
    the least a kernel that stops at a row's first pad must read: a row's
    cols up to that pad (min(width, deg + 1) slots) in 32-byte sectors, the
    valid weights, the v rows (single: min(nnz, N) values; Q-wide: each row
    the bucket touches once) and the output.  Asserts first that every row is left-packed (no valid
    slot after a pad), the kernels' precondition.  Prints one line a bucket
    and the sum over the buckets (one launch each per iteration), fills the
    kernels line's ``row`` from the largest bucket (most slots of the
    layout; with its plain version's time and error) and returns the
    per-bucket dicts."""
    from repro_torch.kernels import ell_spmv

    multi = v.ndim == 2
    nq = v.shape[1] if multi else 1
    fn = ell_spmv.ell_gimv_multi if multi else ell_spmv.ell_gimv
    out, total, total_lib = [], 0.0, 0.0
    for i, bk in enumerate(buckets):
        cols, w = bk.cols, bk.w
        r_, d_ = cols.shape
        valid = cols >= 0
        if bool((valid[:, 1:] & ~valid[:, :-1]).any()):
            raise SmokeError(f"{label} ell bucket {i} {[r_, d_]}: a valid slot after a pad "
                             "(rows must be left-packed)")
        deg = valid.sum(dim=1)
        nnz = int(deg.sum())
        longest = int(deg.max()) if r_ else 0
        sectors = int(((torch.clamp(deg + 1, max=d_) + 7) // 8).sum())   # 8 cols a sector
        touched = int(torch.unique(cols[valid]).numel()) if multi else min(nnz, v.shape[0])
        ms = time_ms(torch, lambda: fn(cols, w, v, semiring="plus_times"), reps)
        crow = torch.zeros(r_ + 1, dtype=torch.int64, device=cols.device)
        crow[1:] = torch.cumsum(deg, 0)
        csr = torch.sparse_csr_tensor(crow, cols[valid].to(torch.int64), w[valid],
                                      size=(r_, v.shape[0]))
        lib = (lambda: torch.sparse.mm(csr, v)) if multi else (lambda: torch.mv(csr, v))
        got = fn(cols, w, v, semiring="plus_times")
        compare(torch, got, lib(), "plus_times", f"{label} ell bucket {i} vs the CSR library call")
        if not torch.equal(got, fn(cols, w, v, semiring="plus_times")):
            raise SmokeError(f"{label} ell bucket {i}: plus_times not the same bits twice")
        lib_ms = time_ms(torch, lib, max(2, reps // 2))
        del valid, crow, csr, got
        out_b = r_ * nq * 4
        layout_ms, _ = bound(r_ * d_ * 4 + nnz * 4 + min(nnz, v.shape[0]) * nq * 4 + out_b,
                             2 * nnz * nq)
        valid_ms, valid_by = bound(sectors * 32 + nnz * 4 + touched * nq * 4 + out_b,
                                   2 * nnz * nq)
        occ = nnz / max(1, r_ * d_)
        out.append(dict(shape=[r_, d_], occupancy=occ, longest_row=longest, nnz=nnz,
                        col_sectors=sectors, ms=ms, library_ms=lib_ms, layout_bound_ms=layout_ms,
                        valid_bound_ms=valid_ms, valid_bound_by=valid_by, touched=touched))
        total += ms
        total_lib += lib_ms
        log(f"bucket {label} {i} {[r_, d_]}{f' x Q={nq}' if multi else ''}: occupancy "
            f"{occ:.4f}, longest row {longest}, kernel {ms:.4f} ms, CSR library {lib_ms:.4f} ms, "
            f"bound {valid_ms:.4f} ms (valid slots, {valid_by}; {sectors} sectors of cols, {nnz} slots, "
            f"{touched} v rows), {layout_ms:.4f} ms (layout); kernel / valid-slot bound "
            f"{ms / valid_ms:.2f}x")
    log(f"buckets {label}: {len(out)} launches per iteration, kernel sum {total:.4f} ms, CSR "
        f"library sum {total_lib:.4f} ms, valid-slot bound sum "
        f"{sum(x['valid_bound_ms'] for x in out):.4f} ms")
    ibig = max(range(len(buckets)), key=lambda i: buckets[i].cols.numel())
    big, tb = buckets[ibig], out[ibig]
    plain = ell_spmv.ell_gimv_multi_ref if multi else ell_spmv.ell_gimv_ref
    plain_ms = time_ms(torch, lambda: plain(big.cols, big.w, v, semiring="plus_times"),
                       2 if multi else 5, warmup=1)
    err = compare(torch, fn(big.cols, big.w, v, semiring="plus_times"),
                  plain(big.cols, big.w, v, semiring="plus_times"), "plus_times",
                  f"{label} ell timed bucket")
    row.update(max_abs_err=err, ms=tb["ms"], plain_ms=plain_ms, bound_ms=tb["valid_bound_ms"],
               bound_by=tb["valid_bound_by"], library_ms=tb["library_ms"], semiring="plus_times",
               shape=tb["shape"] + ([nq] if multi else []), occupancy=tb["occupancy"],
               iteration_ms=total)
    log(f"time {fn.__name__} plus_times {tb['shape']}{f' x Q={nq}' if multi else ''} occupancy "
        f"{tb['occupancy']:.4f}: kernel {tb['ms']:.3f} ms, plain {plain_ms:.3f} ms, CSR library "
        f"{tb['library_ms']:.3f} ms, bound {tb['valid_bound_ms']:.4f} ms (valid slots, "
        f"{tb['valid_bound_by']}), {tb['layout_bound_ms']:.3f} ms (layout); all "
        f"{len(buckets)} buckets {total:.3f} ms")
    return out


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


def sender_order_fold(torch, rows, val, n_rows: int, semiring: str):
    """The fold of the Q-wide scatter kernels in plain torch: the identity,
    then the slots of sender 0, 1, ... combined in, one sender at a time.
    rows [S, B, p]: each slot's flat output row (n_rows or more: dropped);
    val [S, B, p, Q] -> [n_rows, Q].  Per output the same order as the
    kernels (and their one-pass-per-sender predecessors), so the same bits,
    plus_times included."""
    from repro_torch.kernels._common import identity

    nq = val.shape[-1]
    out = torch.full((n_rows, nq), identity(semiring, val.dtype), dtype=val.dtype,
                     device=val.device)
    op = {"plus_times": torch.add, "min_plus": torch.minimum, "max_plus": torch.maximum,
          "min_src": torch.minimum}[semiring]
    for k in range(rows.shape[1]):
        r, v = rows[:, k].reshape(-1), val[:, k].reshape(-1, nq)
        keep = r < n_rows
        r, v = r[keep], v[keep]
        out[r] = op(out[r], v)
    return out


def sparse_rows(torch, idx, n_local: int):
    """Flat output rows of the compacted idx [S, B, cap] (n_local and more
    -> S * n_local, dropped)."""
    sets = idx.shape[0]
    base = torch.arange(sets, device=idx.device, dtype=torch.int64)[:, None, None] * n_local
    return torch.where(idx < n_local, idx.to(torch.int64) + base, sets * n_local)


def check_sender_order(torch, got, rows, val, n_rows, semiring, what) -> None:
    want = sender_order_fold(torch, rows, val, n_rows, semiring)
    if not torch.equal(got.reshape(want.shape), want):
        err = float((got.reshape(want.shape).double() - want.double()).abs().nan_to_num(0.0).max())
        raise SmokeError(f"{what}: not the bits of the sender-order fold (max |err| {err})")


def pagerank_ref(np, sp, edges, n, iters, d=0.85):
    src, dst = edges[:, 0], edges[:, 1]
    out = np.bincount(src, minlength=n)
    w = 1.0 / np.maximum(out, 1)[src]
    a = sp.csr_matrix((w, (dst, src)), shape=(n, n))
    v = np.full(n, 1.0 / n)
    for _ in range(iters):
        v = (1.0 - d) / n + d * (a @ v)
    return v


def rwr_ref(np, sp, edges, n, sources, iters, c=0.85):
    """RWR of the port's formula, v <- (1-c) e_s + c A v from v = e_s, for
    each source after its own iteration count (one CSR product per step for
    all sources together)."""
    src, dst = edges[:, 0], edges[:, 1]
    out = np.bincount(src, minlength=n)
    a = sp.csr_matrix((1.0 / np.maximum(out, 1)[src], (dst, src)), shape=(n, n))
    e = np.zeros((n, len(sources)))
    e[np.asarray(sources), np.arange(len(sources))] = 1.0
    v, want = e.copy(), np.zeros_like(e)
    for k in range(1, max(iters) + 1):
        v = (1.0 - c) * e + c * (a @ v)
        for j, it in enumerate(iters):
            if it == k:
                want[:, j] = v[:, j]
    return want


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
# serve phase


def ell_multi_sweep(torch, rand_block, label, buckets, v_served, semiring) -> None:
    """``ell_gimv_multi`` on every bucket against its plain version: with
    the run's semiring on the served state and a random block, then for 4
    semirings + int32 min_src on random blocks at Q = 64 and 5; plus_times
    the same bits twice.  ``rand_block(rows, nq, dtype)`` makes the blocks."""
    from repro_torch.kernels import ell_spmv

    sweep = (("plus_times", torch.float32), ("min_plus", torch.float32),
             ("max_plus", torch.float32), ("min_src", torch.float32), ("min_src", torch.int32))
    rows_ = v_served.shape[0]
    for which, v in (("served", v_served), ("random", rand_block(rows_, 64, torch.float32))):
        for i, bk in enumerate(buckets):
            compare(torch, ell_spmv.ell_gimv_multi(bk.cols, bk.w, v, semiring=semiring),
                    ell_spmv.ell_gimv_multi_ref(bk.cols, bk.w, v, semiring=semiring),
                    semiring, f"{label} ell bucket {i} {tuple(bk.cols.shape)} {which} v")
        del v
    for nq in (64, 5):
        for sr, dtype in sweep:
            v = rand_block(rows_, nq, dtype)
            for i, bk in enumerate(buckets):
                got = ell_spmv.ell_gimv_multi(bk.cols, bk.w, v, semiring=sr)
                what = f"{label} ell bucket {i} {sr} {dtype} Q={nq} {tuple(bk.cols.shape)}"
                compare(torch, got, ell_spmv.ell_gimv_multi_ref(bk.cols, bk.w, v, semiring=sr),
                        sr, what)
                if sr == "plus_times" and not torch.equal(
                        got, ell_spmv.ell_gimv_multi(bk.cols, bk.w, v, semiring=sr)):
                    raise SmokeError(f"{what}: not the same bits twice")
                del got
            del v


def serve_phase(seed, torch, np, sp, csgraph, dev, gen, edges, n, b, theta, rows, failures):
    """PMVServer on the card: 96 RWR + 96 SSSP queries, interleaved, hybrid
    placement, backend='auto', scatter='kernel', default buckets (8, 16, 32,
    64): each family fills one 64-wide batch and admits 32 queries mid-batch.
    Checks every answer's retirement, 8 RWR / 16 SSSP answers against scipy,
    4 per family against the single-query engine, the launch counters, and
    the three Q-wide kernels against their plain versions at the run's own
    shapes; then times them and profiles 3 batched iterations per family.
    Returns the RWR answers on the host, in submission order, as (source,
    vector, iterations)."""
    from repro_torch import kernels
    from repro_torch.core import placement, sparse_exchange
    from repro_torch.kernels import block_gimv, ell_spmv, scatter_combine
    from repro_torch.serving import FAMILIES, PMVServer, Query, make_batched_step

    outdeg = np.bincount(edges[:, 0], minlength=n)
    srcs = np.random.default_rng(seed).choice(np.flatnonzero(outdeg >= 1), 192,
                                                   replace=False)
    queries = []
    for i in range(96):
        queries.append(Query("rwr", source=int(srcs[2 * i]), c=0.85, tol=1e-6))
        queries.append(Query("sssp", source=int(srcs[2 * i + 1]), tol=0.5))
    srv = PMVServer(edges, n, b=b, strategy="hybrid", theta=theta, backend="auto",
                    scatter="kernel", stream="off", device=dev, max_iters=200)
    fams = {}
    for kind, q0 in (("rwr", queries[0]), ("sssp", queries[1])):
        t = time.perf_counter()
        eng, fspec = srv.engine_for(q0)
        matrix, _, _, fmask, fmeta = eng.prepare(fspec)
        fams[kind] = (eng, fspec, matrix, fmask, fmeta)
        hm, dm = fmeta["hm"], matrix["dense_matrix"]
        log(f"serve family {kind}: prepare_s={fmeta['prepare_s']:.2f} "
            f"(wall {time.perf_counter() - t:.1f} s) strategy={fmeta['strategy']} "
            f"backend={fmeta['backend']} theta={fmeta['theta']} dense vertices={fmeta['n_dense']} "
            f"d_cap={hm.dense.d_cap} dense matrix={list(dm.shape)} "
            f"({dm.numel() * 4 / 1e9:.2f} GB) capacity={fmeta['capacity']} "
            f"ell buckets {[list(bk.cols.shape) for bk in matrix['planned_sparse'].buckets]}")
        if fmeta["backend"] != "planned":
            raise SmokeError(f"serve {kind}: backend resolved to {fmeta['backend']!r}")
    torch.cuda.synchronize()
    log(f"serve resident: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    results = srv.serve(queries)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = srv.stats()
    lat = [r.latency_s for r in results]
    walls = [1e3 * w for w in st["iter_wall_s"]]
    by_kind = {k: [r for r in results if r.query.spec_kind == k] for k in ("rwr", "sssp")}
    iters = {k: [r.iterations for r in v] for k, v in by_kind.items()}
    log(f"serve: {len(results)} queries in {serve_s:.3f} s -> {len(results) / serve_s:.3f} "
        f"queries/s; latency p50 {percentile(lat, 50):.3f} s p99 {percentile(lat, 99):.3f} s; "
        f"batches={st['batches']} admitted_mid_batch={st['admitted_mid_batch']} "
        f"batched iterations={int(st['iterations'])} median_iter_ms={np.median(walls):.3f} "
        f"p99_iter_ms={percentile(walls, 99):.3f} max_iter_ms={max(walls):.3f} "
        f"peak_gib={peak:.2f} reasons={json.dumps(st['retirement_reasons'])} "
        f"query iterations rwr {min(iters['rwr'])}-{max(iters['rwr'])} "
        f"sssp {min(iters['sssp'])}-{max(iters['sssp'])} launches={json.dumps(counts)}")

    # -- checks -------------------------------------------------------------
    bad = [r.qid for r in results if r.reason != "completed" or not r.converged]
    if bad:
        failures.append(f"serve: {len(bad)} queries did not retire completed and converged "
                        f"(qids {bad[:10]})")
    if st["batches"] != 2 or st["admitted_mid_batch"] != 64:
        failures.append(f"serve: expected 2 batches and 64 mid-batch admissions, got "
                        f"{st['batches']} and {st['admitted_mid_batch']}")
    for name in MULTI:
        if counts[name] == 0:
            raise SmokeError(f"serve: kernel {name} never launched on the serve path")
        rows.setdefault(name, {"launches": 0})["launches"] += counts[name]
    for name in SINGLE:
        if counts[name] != 0:
            raise SmokeError(f"serve: single-vector kernel {name} launched {counts[name]} "
                             "times while serving")
    pick = by_kind["rwr"][::12][:8]
    want = rwr_ref(np, sp, edges, n, [r.query.source for r in pick], [r.iterations for r in pick])
    got = np.stack([r.vector for r in pick], axis=1)
    ok = np.allclose(got, want, rtol=1e-4, atol=1e-12)
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    log(f"check serve rwr x{len(pick)} vs scipy power iteration (their own iteration counts): "
        f"max rel err {rel:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("served rwr disagrees with scipy")
    pick = by_kind["sssp"][::6][:16]
    want = sssp_ref(np, sp, csgraph, edges, n, [r.query.source for r in pick])
    ok = all(np.array_equal(r.vector.astype(np.float64), want[j]) for j, r in enumerate(pick))
    log(f"check serve sssp x{len(pick)} vs scipy shortest_path: reached "
        f"{int(np.isfinite(want).sum())} (source, vertex) pairs -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("served sssp disagrees with scipy")
    for kind in ("rwr", "sssp"):
        eng, fspec = fams[kind][:2]
        fam = FAMILIES[kind]
        for r in by_kind[kind][::24][:4]:
            q = r.query
            if kind == "sssp":
                one = eng.run(fspec, fam.ctx_columns(n, q) or None, max_iters=srv.max_iters,
                              tol=q.tol, v0=fam.init_column(n, q))
                ok = one.converged and one.iterations == r.iterations and \
                    np.array_equal(one.v, r.vector)
            else:
                # exactly the served query's step count (tol -1 never stops
                # early), so the two differ by float32 rounding only
                one = eng.run(fspec, fam.ctx_columns(n, q) or None, max_iters=r.iterations,
                              tol=-1.0, v0=fam.init_column(n, q))
                ok = one.iterations == r.iterations and \
                    np.allclose(one.v, r.vector, rtol=1e-4, atol=1e-12)
            log(f"check serve {kind} qid {r.qid} (source {q.source}) vs single-query "
                f"PMVEngine.run: iterations {r.iterations} / {one.iterations} -> "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"served {kind} qid {r.qid} disagrees with the single-query run")

    # -- the Q-wide kernels against their plain versions, at the run's shapes --
    def rand_block(rows_, nq, dtype=torch.float32):
        if dtype == torch.int32:
            return torch.randint(0, n, (rows_, nq), generator=gen, device=dev, dtype=torch.int32)
        return torch.rand((rows_, nq), generator=gen, device=dev)

    sweep = (("plus_times", torch.float32), ("min_plus", torch.float32),
             ("max_plus", torch.float32), ("min_src", torch.float32), ("min_src", torch.int32))
    states, buffers = {}, {}
    for kind in ("rwr", "sssp"):
        eng, fspec, matrix, fmask, fmeta = fams[kind]
        semiring = "plus_times" if kind == "rwr" else "min_plus"
        part = fmeta["part"]
        nl = part.n_local
        state = np.stack([part.to_blocked(r.vector) for r in by_kind[kind][:64]], axis=-1)
        v_state = torch.from_numpy(np.ascontiguousarray(state)).to(dev)    # [b, nl, 64]
        states[kind] = v_state
        v_flat = v_state.reshape(-1, 64)
        fp = matrix["planned_sparse"]
        ell_multi_sweep(torch, rand_block, f"serve {kind}", fp.buckets, v_flat, semiring)
        gidx = matrix["dense_region"].gather_idx
        v_d = torch.gather(v_state, 1, gidx[:, :, None].expand(-1, -1, 64)).reshape(-1, 64)
        dm = matrix["dense_matrix"]
        for v in (v_d.contiguous(), v_d[:, :5].contiguous()):
            compare(torch, block_gimv.dense_gimv_multi(dm, v, semiring=semiring),
                    block_gimv.dense_gimv_multi_ref(dm, v, semiring=semiring), semiring,
                    f"serve {kind} dense {tuple(dm.shape)} x served Q={v.shape[1]}")
        if kind == "rwr":   # finite matrix values: every semiring on it
            for nq in (64, 5):
                for sr, dtype in sweep:
                    v = rand_block(dm.shape[1], nq, dtype)
                    compare(torch, block_gimv.dense_gimv_multi(dm, v, semiring=sr),
                            block_gimv.dense_gimv_multi_ref(dm, v, semiring=sr), sr,
                            f"serve dense {sr} {dtype} Q={nq} {tuple(dm.shape)}")
        partials = placement._planned_vertical_partials(fspec, fp, v_state, nl)
        idx, val, _, _ = sparse_exchange.compact_partials(fspec, partials, fmeta["capacity"],
                                                          batched=True)
        del partials
        idx_x, val_x = idx.transpose(0, 1).contiguous(), val.transpose(0, 1).contiguous()
        del idx, val
        buffers[kind] = (idx_x, val_x, nl)
        rows_x = sparse_rows(torch, idx_x, nl)
        for vv in (val_x, val_x[..., :5].contiguous()):
            got = scatter_combine.scatter_combine_gimv_multi(idx_x, vv, nl, semiring=semiring)
            what = f"serve {kind} scatter {tuple(vv.shape)} served"
            compare(torch, got, scatter_combine.scatter_combine_multi_ref(
                idx_x, vv, nl, semiring=semiring), semiring, what)
            check_sender_order(torch, got, rows_x, vv, idx_x.shape[0] * nl, semiring, what)
            del got
        del rows_x
        log(f"kernels serve {kind}: ell_gimv_multi on {len(fp.buckets)} buckets (served and "
            f"random v), each for 4 semirings and int32 at Q=64 and 5 (plus_times the same "
            f"bits twice); dense_gimv_multi {list(dm.shape)}; "
            f"scatter_combine_multi {list(val_x.shape)} -- all match their plain versions")
    idx_x, val_x, nl = buffers["sssp"]
    shape = tuple(val_x.shape)
    rows_x = sparse_rows(torch, idx_x, nl)
    for nq in (64, 5, 67):
        for sr, dtype in sweep:
            vv = rand_block(shape[0] * shape[1] * shape[2], nq, dtype).reshape(shape[:3] + (nq,))
            got = scatter_combine.scatter_combine_gimv_multi(idx_x, vv, nl, semiring=sr)
            what = f"serve scatter {sr} {dtype} Q={nq} {tuple(idx_x.shape)}"
            compare(torch, got, scatter_combine.scatter_combine_multi_ref(idx_x, vv, nl,
                                                                          semiring=sr), sr, what)
            check_sender_order(torch, got, rows_x, vv, shape[0] * nl, sr, what)
            del vv, got
    del rows_x
    rv = torch.rand(val_x.shape, generator=gen, device=dev)
    r1 = scatter_combine.scatter_combine_gimv_multi(idx_x, rv, nl, semiring="plus_times")
    r2 = scatter_combine.scatter_combine_gimv_multi(idx_x, rv, nl, semiring="plus_times")
    if not torch.equal(r1, r2):
        raise SmokeError("scatter_combine_multi plus_times is not reproducible run to run")
    del rv, r1, r2
    log("kernels serve: scatter_combine_multi matches its plain version for 4 semirings and "
        "int32 at Q=64, 5 and 67 and is bitwise the sender-order fold (the parent kernel's "
        "order) there and on the served buffers; plus_times bitwise reproducible")

    # -- times: kernel, plain version, library yardstick, bound ----------------
    matrix = fams["rwr"][2]
    ell_bucket_times(torch, "serve rwr Q=64", matrix["planned_sparse"].buckets,
                     states["rwr"].reshape(-1, 64), rows["ell_gimv_multi"])
    nq = 64

    dm = matrix["dense_matrix"]
    m_, k_ = dm.shape
    vf = rand_block(k_, nq)
    ms = time_ms(torch, lambda: block_gimv.dense_gimv_multi(dm, vf, semiring="plus_times"), 10)
    plain_ms = time_ms(torch, lambda: block_gimv.dense_gimv_multi_ref(dm, vf,
                                                                      semiring="plus_times"), 2,
                       warmup=1)
    lib_ms = time_ms(torch, lambda: torch.matmul(dm, vf), 10)
    got = block_gimv.dense_gimv_multi(dm, vf, semiring="plus_times")
    err = compare(torch, got, block_gimv.dense_gimv_multi_ref(dm, vf, semiring="plus_times"),
                  "plus_times", "dense multi timed call")
    compare(torch, got, torch.matmul(dm, vf), "plus_times", "dense multi vs torch.matmul")
    # tensor cores (3xTF32), a fixed k order and no split-K: the same bits twice
    if not torch.equal(got, block_gimv.dense_gimv_multi(dm, vf, semiring="plus_times")):
        raise SmokeError("dense_gimv_multi plus_times is not the same bits twice")
    # relative error against a float64 product on the first 8192 rows, beside
    # torch.matmul's: the largest, and the mean with its sign (a drift)
    exact = dm[:8192].double() @ vf.double()
    nz = exact != 0
    if not bool(nz.any()):
        raise SmokeError("dense multi: the first 8192 rows of the dense matrix are empty")
    rel = {}
    for what, r in (("kernel", got[:8192]), ("torch.matmul", torch.matmul(dm[:8192], vf))):
        d = ((r.double() - exact) / exact)[nz]
        rel[what] = (float(d.abs().max()), float(d.mean()))
    del exact, nz
    sdm = fams["sssp"][2]["dense_matrix"]
    sm_, sk_ = sdm.shape
    vs = rand_block(sk_, nq)
    ms_min = time_ms(torch, lambda: block_gimv.dense_gimv_multi(sdm, vs, semiring="min_plus"), 10)
    # plus_times: M, V and R once over the memory rate; the three TF32 products
    # over the tensor cores' rate (what the kernel does), and one FP32 FMA
    # product over the CUDA cores' (what a float32 kernel without them does)
    bytes_ms = (m_ * k_ * 4 + k_ * nq * 4 + m_ * nq * 4) / H100_BYTES_PER_S * 1e3
    tf32_ms = 3 * 2 * m_ * k_ * nq / H100_TF32_OPS_PER_S * 1e3
    fp32_ms = 2 * m_ * k_ * nq / H100_F32_OPS_PER_S * 1e3
    b_ms, b_by = (bytes_ms, "bytes") if bytes_ms >= tf32_ms else (tf32_ms, "operations")
    # min_plus: an add and a min per cell, lane instructions at half the FP32 rate
    min_bound_ms = 2 * sm_ * sk_ * nq / (H100_F32_OPS_PER_S / 2) * 1e3
    rows["dense_gimv_multi"].update(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, semiring="plus_times", shape=[m_, k_, nq],
        tflops=2 * m_ * k_ * nq / ms / 1e9, min_plus_ms=ms_min,
        min_plus_shape=[sm_, sk_, nq],
        rel_err_max=rel["kernel"][0], rel_err_mean=rel["kernel"][1],
        matmul_rel_err_max=rel["torch.matmul"][0], matmul_rel_err_mean=rel["torch.matmul"][1])
    log(f"time dense_gimv_multi {[m_, k_]} x Q={nq}: plus_times kernel (3xTF32) {ms:.3f} ms "
        f"({2 * m_ * k_ * nq / ms / 1e9:.2f} TFLOP/s), the same bits twice; plain "
        f"{plain_ms:.3f} ms, torch.matmul (FP32, no TF32) {lib_ms:.3f} ms; bounds: bytes "
        f"{bytes_ms:.3f} ms, FP32 operations {fp32_ms:.3f} ms, 3xTF32 operations "
        f"{tf32_ms:.3f} ms; min_plus {[sm_, sk_]} kernel {ms_min:.3f} ms against its "
        f"{min_bound_ms:.3f} ms instruction bound; relative error against float64 on 8192 "
        f"rows: kernel max {rel['kernel'][0]:.3e} mean {rel['kernel'][1]:.3e}, torch.matmul "
        f"max {rel['torch.matmul'][0]:.3e} mean {rel['torch.matmul'][1]:.3e}")
    del got, vf, vs

    # kernel 6 on both families' served buffers: min_plus (SSSP) against
    # index_reduce_, plus_times (RWR, the serve's own fold) against
    # index_add_, both libraries at the valid slots; one launch per call
    times = {}
    for kind, sr in (("sssp", "min_plus"), ("rwr", "plus_times")):
        idx_x, val_x, nl = buffers[kind]
        s_, b_, cap, _ = val_x.shape
        call = (lambda idx_x=idx_x, val_x=val_x, nl=nl, sr=sr:
                scatter_combine.scatter_combine_gimv_multi(idx_x, val_x, nl, semiring=sr))
        ms = time_ms(torch, call, 20)
        plain_ms = time_ms(torch, lambda: scatter_combine.scatter_combine_multi_ref(
            idx_x, val_x, nl, semiring=sr), 5, warmup=1)
        got = call()
        err = compare(torch, got, scatter_combine.scatter_combine_multi_ref(
            idx_x, val_x, nl, semiring=sr), sr, f"scatter multi {kind} timed call")
        flat = idx_x.reshape(s_, -1).to(torch.int64)
        keep = (flat < nl).reshape(-1)
        flat = (flat + torch.arange(s_, device=dev)[:, None] * nl).reshape(-1)[keep]
        fval = val_x.reshape(-1, nq)[keep]
        if sr == "min_plus":
            base = torch.full((s_ * nl, nq), float("inf"), device=dev)
            lib_call = lambda base=base, flat=flat, fval=fval: base.clone().index_reduce_(  # noqa: E731
                0, flat, fval, "amin")
            lib_name = "index_reduce_"
        else:
            base = torch.zeros((s_ * nl, nq), device=dev)
            lib_call = lambda base=base, flat=flat, fval=fval: base.clone().index_add_(  # noqa: E731
                0, flat, fval)
            lib_name = "index_add_"
        lib_ms = time_ms(torch, lib_call, 20)
        compare(torch, got, lib_call().reshape(s_, nl, nq), sr, f"scatter multi vs {lib_name}")
        per_call, dev_ms, seen = profiled_calls(torch, call, "scatter_combine_multi")
        if per_call != 1:
            raise SmokeError(f"scatter_combine_multi: {per_call} device launches per call, not 1 "
                             f"(launches by class over 20 calls: {json.dumps(seen)})")
        n_valid = int(keep.sum())
        # the kernel reads a row's valid prefix only: each valid slot's index
        # and Q values once, the output written once
        b_ms, b_by = bound(n_valid * 4 + n_valid * nq * 4 + s_ * nl * nq * 4, n_valid * nq)
        times[sr] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, err=err, bound_ms=b_ms,
                         bound_by=b_by, shape=[s_, b_, cap, nq], n_local=nl, n_valid=n_valid,
                         device_ms=dev_ms, per_call=per_call)
        log(f"time scatter_combine_multi {sr} ({kind} served buffers) {[s_, b_, cap, nq]} "
            f"n_local {nl} valid {n_valid}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"{lib_name} {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); profiler: "
            f"{per_call:g} device launches per call, device {dev_ms:.4f} ms per call")
        del got, flat, fval, base, keep, lib_call
    mp, pt = times["min_plus"], times["plus_times"]
    rows["scatter_combine_multi"].update(
        max_abs_err=mp["err"], ms=mp["ms"], plain_ms=mp["plain_ms"], bound_ms=mp["bound_ms"],
        bound_by=mp["bound_by"], library_ms=mp["lib_ms"], semiring="min_plus",
        shape=mp["shape"], n_local=mp["n_local"], valid_slots=mp["n_valid"],
        device_launches_per_call=mp["per_call"], device_ms=mp["device_ms"],
        plus_times_ms=pt["ms"], plus_times_library_ms=pt["lib_ms"],
        plus_times_bound_ms=pt["bound_ms"], plus_times_plain_ms=pt["plain_ms"],
        plus_times_max_abs_err=pt["err"], plus_times_shape=pt["shape"],
        plus_times_valid_slots=pt["n_valid"], plus_times_device_ms=pt["device_ms"])
    del buffers

    # -- profile 3 batched iterations per family --------------------------------
    for kind in ("rwr", "sssp"):
        eng, fspec, matrix, fmask, fmeta = fams[kind]
        fam = FAMILIES[kind]
        step = make_batched_step(fspec, fmeta["cfg"], delta_kind=fam.delta_kind)
        part = fmeta["part"]
        ctx = {}
        if kind == "rwr":
            restart = np.stack([part.to_blocked(fam.ctx_columns(n, r.query)["restart"])
                                for r in by_kind[kind][:64]], axis=-1)
            ctx["restart"] = torch.from_numpy(np.ascontiguousarray(restart)).to(dev)
        active = torch.ones(64, dtype=torch.bool, device=dev)

        def three(step=step, matrix=matrix, ctx=ctx, fmask=fmask, v=states[kind]):
            for _ in range(3):
                v, deltas, _ = step(matrix, v, ctx, fmask, active)
                deltas.tolist()      # the server's one host copy per iteration

        prof = device_breakdown(torch, three, 3)
        log(f"profile serve {kind} (3 batched iterations, Q=64): {json.dumps(prof)}")
    srv.close()
    del fams, states
    torch.cuda.empty_cache()
    return [(r.query.source, r.vector, r.iterations) for r in by_kind["rwr"]]


# ---------------------------------------------------------------------------
# packed exchange phases

PACKED_SWEEP = (("plus_times", "float32"), ("min_plus", "float32"), ("max_plus", "float32"),
                ("min_src", "float32"), ("min_src", "int32"))


def semiring_spec(np, semiring: str, dtype: str):
    """A GimvSpec of ``semiring`` over ``dtype`` (gather and compaction read
    only its identity)."""
    from repro_torch.core import GimvSpec

    c2, call = {"plus_times": ("mul", "sum"), "min_plus": ("add", "min"),
                "max_plus": ("add", "max"), "min_src": ("src", "min")}[semiring]
    return GimvSpec(name=semiring, combine2=c2, combine_all=call, dtype=np.dtype(dtype).type,
                    assign=lambda v, r, ctx: r, init=lambda ids, ctx: ids)


def rand_values(torch, gen, dev, shape, spec, identity_share=0.2):
    """Random values of ``spec``'s type, ``identity_share`` of them its
    identity."""
    if spec.torch_dtype == torch.int32:
        x = torch.randint(0, 1000, shape, generator=gen, device=dev, dtype=torch.int32)
    else:
        x = torch.rand(shape, generator=gen, device=dev)
    ident = torch.rand(shape, generator=gen, device=dev) < identity_share
    return x.masked_fill_(ident, spec.identity)


def structured_partials(torch, gen, spec, send_rows, n_local, nq):
    """Partials [b_w, b, n_local(, Q)] with random values on the structural
    rows of ``send_rows`` (a fifth of them the identity) and the identity on
    every other row, as a GIM-V step's partials are."""
    dev = send_rows.device
    tail = () if nq is None else (nq,)
    vals = rand_values(torch, gen, dev, tuple(send_rows.shape) + tail, spec)
    part = torch.full(tuple(send_rows.shape[:2]) + (n_local + 1,) + tail, spec.identity,
                      dtype=spec.torch_dtype, device=dev)
    idx = send_rows.to(torch.int64)
    if nq is not None:
        idx = idx[..., None].expand(-1, -1, -1, nq)
    part.scatter_(2, idx, vals)     # the sentinel rows land in row n_local, cut below
    return part[:, :, :n_local].contiguous()


def packed_vs_sparse(torch, spec, partials, xchg, xplan, capacity, n_local, what):
    """Fold ``partials`` through the packed exchange's kernel (gathered at
    the static send order) and through the sparse exchange's kernel (the
    compacted buffers): the same bits for every semiring, both folding the
    senders of a set in order."""
    from repro_torch.core import sparse_exchange
    from repro_torch.exchange import gather_payload, scatter_payload

    batched = partials.ndim == 4
    payload = gather_payload(spec, partials, xchg["send_rows"])
    got = scatter_payload(spec, payload.transpose(0, 1).contiguous(), n_local,
                          recv_words=xchg["recv_words"], p_dev=xplan.p_dev,
                          width=xplan.width_dev, method="kernel")
    del payload
    idx, val, over, _ = sparse_exchange.compact_partials(spec, partials, capacity,
                                                         batched=batched)
    if float(over) != 0.0:
        raise SmokeError(f"{what}: compaction overflowed capacity {capacity}")
    want = sparse_exchange.scatter_partials(spec, idx.transpose(0, 1).contiguous(),
                                            val.transpose(0, 1).contiguous(), n_local,
                                            method="kernel")
    if not torch.equal(got, want):
        err = float((got.double() - want.double()).abs().nan_to_num(0.0).max())
        raise SmokeError(f"{what}: packed kernel and sparse kernel folds differ "
                         f"(max |err| {err})")


def packed_time_row(torch, dev, name, words, val, n_out, kw, structural, rows):
    """Time one packed kernel at a run's shapes against its plain version and
    index_add_ of the structural slots at pre-decoded ids (the yardstick
    leaves out the decode and the sentinel slots)."""
    from repro_torch.kernels import scatter_combine
    from repro_torch.kernels.scatter_combine.ref import packed_targets

    multi = val.ndim == 2
    nq = val.shape[1] if multi else 1
    fn = (scatter_combine.packed_scatter_combine_gimv_multi if multi
          else scatter_combine.packed_scatter_combine_gimv)
    ref = (scatter_combine.packed_scatter_combine_multi_ref if multi
           else scatter_combine.packed_scatter_combine_ref)
    plain_kw = {k: v for k, v in kw.items() if k != "senders"}
    ms = time_ms(torch, lambda: fn(words, val, n_out, **kw), 20)
    plain_ms = time_ms(torch, lambda: ref(words, val, n_out, **plain_kw), 3, warmup=1)
    got = fn(words, val, n_out, **kw)
    err = compare(torch, got, ref(words, val, n_out, **plain_kw), kw["semiring"],
                  f"{name} timed call")
    tgt = packed_targets(words, val.shape[0], n_out, set_slots=kw["set_slots"],
                         n_local=kw["n_local"], width=kw["width"])
    keep = tgt < n_out
    tgt, val_s = tgt[keep], val[keep]
    base = torch.zeros((n_out,) + tuple(val.shape[1:]), dtype=val.dtype, device=dev)
    lib_ms = time_ms(torch, lambda: base.clone().index_add_(0, tgt, val_s), 20)
    compare(torch, got, base.clone().index_add_(0, tgt, val_s), kw["semiring"],
            f"{name} vs index_add_")
    # device time and launches per call from the profiler: the CUDA-event
    # times above also hold the wrapper's host work between launches
    per_call, dev_ms, seen = profiled_calls(torch, lambda: fn(words, val, n_out, **kw), name)
    _, lib_dev_ms, _ = profiled_calls(torch, lambda: base.clone().index_add_(0, tgt, val_s), "all")
    if per_call != 1:
        raise SmokeError(f"{name}: {per_call} device launches per call, not 1 (launches by "
                         f"class over 20 calls: {json.dumps(seen)})")
    del tgt, val_s, keep, base
    # the tile kernels read a row's structural prefix only: its slots' W-bit
    # ids and values once, the output written once
    nbytes = structural * kw["width"] / 8 + structural * nq * 4 + n_out * nq * 4
    b_ms, b_by = bound(nbytes, structural * nq)
    rows[name].update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                      library_ms=lib_ms, semiring=kw["semiring"],
                      shape=[int(val.shape[0])] + ([nq] if multi else []),
                      width=kw["width"], n_local=kw["n_local"], structural_slots=structural,
                      device_launches_per_call=per_call, device_ms=dev_ms,
                      library_device_ms=lib_dev_ms)
    log(f"time {name} {kw['semiring']} slots {val.shape[0]}{f' x Q={nq}' if multi else ''} "
        f"width {kw['width']} n_local {kw['n_local']} structural {structural}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, index_add_ of the structural slots at pre-decoded ids "
        f"{lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); profiler: {per_call:g} device launches per call, "
        f"device {dev_ms:.4f} ms per call (index_add_ with its clone {lib_dev_ms:.4f} ms)")


def packed_run_checks(torch, np, dev, gen, eng, spec, res, meta, rows):
    """The packed PageRank run's plan, delta rows and wire bytes; kernel 7 on
    the run's own buffers against its plain version (4 semirings + int32
    min_src), bitwise against the sparse kernel on the compacted buffers of
    the same partials, the same bits twice; its times."""
    from repro_torch.core import cost_model, placement
    from repro_torch.exchange import gather_payload
    from repro_torch.kernels import scatter_combine

    matrix = eng.prepare(spec)[0]
    xp, xchg, part = meta["cfg"].xplan, matrix["xchg"], meta["part"]
    nl, b, cap = part.n_local, xp.b, meta["capacity"]
    log(f"exchange plan: exchange={meta['exchange']} ({meta['exchange_decision']}) b={b} "
        f"n_local={nl} p_cap={xp.p_cap} p_dev={xp.p_dev} width_dev={xp.width_dev} "
        f"payload_slots={xp.payload_slots} id_bytes={xp.id_bytes} "
        f"bitmap_bytes={xp.bitmap_bytes} capacity={cap} delta_eps={meta['delta_eps']} "
        f"({meta['delta_reason']})")
    if meta["exchange"] != "packed" or meta["delta_reason"] != "active":
        raise SmokeError(f"packed run resolved exchange={meta['exchange']!r}, "
                         f"delta {meta['delta_reason']!r}")
    sent = [int(r["delta_sent_rows"]) for r in res.per_iter]
    supp = [int(r["delta_suppressed_rows"]) for r in res.per_iter]
    log(f"delta rows per iteration: sent {sent}; suppressed {supp}")
    wire = res.totals["wire_bytes"]
    padded = cost_model.padded_exchange_bytes(b, cap, None, 4) * res.iterations
    log(f"wire bytes over {res.iterations} iterations: packed {wire:.0f} (ids once "
        f"{res.totals['exchange_id_bytes']:.0f} + payload and bitmaps "
        f"{res.totals['exchange_payload_bytes']:.0f}) vs the padded stream's {padded:.0f} "
        f"at capacity {cap}: {padded / wire:.3f}x")

    v_local = torch.from_numpy(part.to_blocked(res.v.astype(np.float32)).copy()).to(dev)
    partials = placement._planned_vertical_partials(spec, matrix["planned"], v_local, nl)
    payload = gather_payload(spec, partials, xchg["send_rows"])
    val_x = payload.transpose(0, 1).contiguous().reshape(-1)
    words = xchg["recv_words"].reshape(-1)
    kw = dict(set_slots=b * xp.p_dev, n_local=nl, width=xp.width_dev)
    n_out = b * (nl + 1)
    compare(torch, scatter_combine.packed_scatter_combine_gimv(
                words, val_x, n_out, semiring="plus_times", senders=b, **kw),
            scatter_combine.packed_scatter_combine_ref(words, val_x, n_out,
                                                       semiring="plus_times", **kw),
            "plus_times", "packed run payload")
    packed_vs_sparse(torch, spec, partials, xchg, xp, cap, nl, "packed run partials plus_times")
    for sr, dt in PACKED_SWEEP:
        s_spec = semiring_spec(np, sr, dt)
        vv = rand_values(torch, gen, dev, tuple(val_x.shape), s_spec)
        compare(torch, scatter_combine.packed_scatter_combine_gimv(
                    words, vv, n_out, semiring=sr, senders=b, **kw),
                scatter_combine.packed_scatter_combine_ref(words, vv, n_out, semiring=sr, **kw),
                sr, f"packed {sr} {dt} {tuple(val_x.shape)}")
        packed_vs_sparse(torch, s_spec, structured_partials(torch, gen, s_spec,
                                                            xchg["send_rows"], nl, None),
                         xchg, xp, cap, nl, f"packed vs sparse {sr} {dt}")
    rv = torch.rand(val_x.shape, generator=gen, device=dev)
    r1 = scatter_combine.packed_scatter_combine_gimv(words, rv, n_out, semiring="plus_times",
                                                     senders=b, **kw)
    r2 = scatter_combine.packed_scatter_combine_gimv(words, rv, n_out, semiring="plus_times",
                                                     senders=b, **kw)
    if not torch.equal(r1, r2):
        raise SmokeError("packed_scatter_combine plus_times is not reproducible run to run")
    log(f"kernels packed run: packed_scatter_combine matches its plain version on "
        f"{list(payload.shape)} (width {xp.width_dev}) for 4 semirings, equals the sparse "
        "kernel on the compacted buffers bitwise, plus_times bitwise reproducible")
    structural = int((xchg["recv_rows"] < nl).sum())
    packed_time_row(torch, dev, "packed_scatter_combine", words, val_x, n_out,
                    dict(kw, semiring="plus_times", senders=b), structural, rows)
    del partials, payload, val_x, rv, r1, r2


def packed_serve_phase(torch, np, dev, gen, edges, n, b, theta, rwr_answers, rows, failures):
    """The 96 RWR queries of the serve phase through PMVServer(exchange=
    'packed'): every answer and iteration count bitwise the sparse serve's;
    kernel 8 on the batched buffers against its plain version (4 semirings +
    int32 min_src, Q = 64 and 5), bitwise against the sparse Q-wide kernel on
    the compacted buffers, the same bits twice; its times; 3 profiled
    batched iterations."""
    from repro_torch import kernels
    from repro_torch.core import placement
    from repro_torch.exchange import gather_payload
    from repro_torch.kernels import scatter_combine
    from repro_torch.kernels.scatter_combine.ref import packed_targets
    from repro_torch.serving import FAMILIES, PMVServer, Query, make_batched_step

    queries = [Query("rwr", source=int(src), c=0.85, tol=1e-6) for src, _, _ in rwr_answers]
    srv = PMVServer(edges, n, b=b, strategy="hybrid", theta=theta, backend="auto",
                    scatter="kernel", exchange="packed", stream="off", device=dev,
                    max_iters=200)
    t = time.perf_counter()
    eng, fspec = srv.engine_for(queries[0])
    matrix, _, _, fmask, fmeta = eng.prepare(fspec)
    xp, xchg, part = fmeta["cfg"].xplan, matrix["xchg"], fmeta["part"]
    nl = part.n_local
    log(f"packed serve family rwr: prepare_s={fmeta['prepare_s']:.2f} (wall "
        f"{time.perf_counter() - t:.1f} s) exchange={fmeta['exchange']} backend="
        f"{fmeta['backend']} capacity={fmeta['capacity']} p_cap={xp.p_cap} p_dev={xp.p_dev} "
        f"width_dev={xp.width_dev} payload_slots={xp.payload_slots} id_bytes={xp.id_bytes}")
    if fmeta["exchange"] != "packed" or fmeta["backend"] != "planned":
        raise SmokeError(f"packed serve resolved exchange={fmeta['exchange']!r} backend="
                         f"{fmeta['backend']!r}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    results = srv.serve(queries)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = srv.stats()
    lat = [r.latency_s for r in results]
    walls = [1e3 * w for w in st["iter_wall_s"]]
    log(f"packed serve: {len(results)} queries in {serve_s:.3f} s -> "
        f"{len(results) / serve_s:.3f} queries/s; latency p50 {percentile(lat, 50):.3f} s "
        f"p99 {percentile(lat, 99):.3f} s; batches={st['batches']} "
        f"admitted_mid_batch={st['admitted_mid_batch']} batched iterations="
        f"{int(st['iterations'])} median_iter_ms={np.median(walls):.3f} "
        f"p99_iter_ms={percentile(walls, 99):.3f} peak_gib={peak:.2f} "
        f"launches={json.dumps(counts)}")
    for name in ("ell_gimv_multi", "dense_gimv_multi", "packed_scatter_combine_multi"):
        if counts[name] == 0:
            raise SmokeError(f"packed serve: kernel {name} never launched on the serve path")
        rows.setdefault(name, {"launches": 0})["launches"] += counts[name]
    for name in SINGLE + ("scatter_combine_multi",):
        if counts[name] != 0:
            raise SmokeError(f"packed serve: kernel {name} launched {counts[name]} times")
    bad = [r.qid for r in results if r.reason != "completed" or not r.converged]
    differ = [j for j, (r, (_, vec, its)) in enumerate(zip(results, rwr_answers))
              if r.iterations != its or not np.array_equal(r.vector, vec)]
    worst = max((float(np.max(np.abs(results[j].vector - rwr_answers[j][1]))) for j in differ),
                default=0.0)
    log(f"check packed serve rwr x{len(results)} vs the sparse serve's answers: "
        f"{len(results) - len(differ)} bitwise with equal iteration counts, {len(differ)} "
        f"differ (max |diff| {worst:.3e}) -> {'ok' if not differ and not bad else 'FAIL'}")
    if bad:
        failures.append(f"packed serve: {len(bad)} queries did not retire completed and "
                        "converged")
    if differ:
        failures.append(f"packed serve: {len(differ)} answers differ from the sparse serve's")

    # -- kernel 8 on the batched buffers ------------------------------------
    state = np.stack([part.to_blocked(r.vector) for r in results[:64]], axis=-1)
    v_state = torch.from_numpy(np.ascontiguousarray(state)).to(dev)     # [b, nl, 64]

    def rand_block(rows_, nq, dtype=torch.float32):
        if dtype == torch.int32:
            return torch.randint(0, n, (rows_, nq), generator=gen, device=dev, dtype=torch.int32)
        return torch.rand((rows_, nq), generator=gen, device=dev)

    buckets = matrix["planned_sparse"].buckets
    ell_multi_sweep(torch, rand_block, "packed serve", buckets, v_state.reshape(-1, 64),
                    "plus_times")
    log(f"kernels packed serve: ell_gimv_multi matches its plain version on {len(buckets)} "
        "buckets (served and random v), each for 4 semirings and int32 at Q=64 and 5 "
        "(plus_times the same bits twice)")
    partials = placement._planned_vertical_partials(fspec, matrix["planned_sparse"], v_state, nl)
    payload = gather_payload(fspec, partials, xchg["send_rows"])
    val_x = payload.transpose(0, 1).contiguous().reshape(-1, 64)
    del payload
    words = xchg["recv_words"].reshape(-1)
    kw = dict(set_slots=b * xp.p_dev, n_local=nl, width=xp.width_dev)
    n_out = b * (nl + 1)
    rows_x = packed_targets(words, val_x.shape[0], n_out, **kw).reshape(b, b, xp.p_dev)
    for vv in (val_x, val_x[:, :5].contiguous()):
        got = scatter_combine.packed_scatter_combine_gimv_multi(
            words, vv, n_out, semiring="plus_times", senders=b, **kw)
        what = f"packed serve payload {tuple(vv.shape)}"
        compare(torch, got, scatter_combine.packed_scatter_combine_multi_ref(
            words, vv, n_out, semiring="plus_times", **kw), "plus_times", what)
        check_sender_order(torch, got, rows_x, vv.reshape(b, b, xp.p_dev, -1), n_out,
                           "plus_times", what)
        del got
    packed_vs_sparse(torch, fspec, partials, xchg, xp, fmeta["capacity"], nl,
                     "packed serve partials plus_times Q=64")
    del partials
    for nq in (64, 5, 67):
        for sr, dt in PACKED_SWEEP:
            s_spec = semiring_spec(np, sr, dt)
            vv = rand_values(torch, gen, dev, (val_x.shape[0], nq), s_spec)
            got = scatter_combine.packed_scatter_combine_gimv_multi(
                words, vv, n_out, semiring=sr, senders=b, **kw)
            what = f"packed multi {sr} {dt} Q={nq}"
            compare(torch, got, scatter_combine.packed_scatter_combine_multi_ref(
                words, vv, n_out, semiring=sr, **kw), sr, what)
            check_sender_order(torch, got, rows_x, vv.reshape(b, b, xp.p_dev, nq), n_out, sr,
                               what)
            del got
            if nq == 64:
                packed_vs_sparse(torch, s_spec, structured_partials(
                    torch, gen, s_spec, xchg["send_rows"], nl, nq), xchg, xp,
                    fmeta["capacity"], nl, f"packed vs sparse multi {sr} {dt} Q={nq}")
            del vv
    rv = torch.rand(val_x.shape, generator=gen, device=dev)
    r1 = scatter_combine.packed_scatter_combine_gimv_multi(words, rv, n_out,
                                                           semiring="plus_times", senders=b, **kw)
    r2 = scatter_combine.packed_scatter_combine_gimv_multi(words, rv, n_out,
                                                           semiring="plus_times", senders=b, **kw)
    if not torch.equal(r1, r2):
        raise SmokeError("packed_scatter_combine_multi plus_times is not reproducible")
    del rv, r1, r2, rows_x
    log(f"kernels packed serve: packed_scatter_combine_multi matches its plain version on "
        f"[{val_x.shape[0]}, 64] (width {xp.width_dev}) for 4 semirings and int32 at Q=64, 5 "
        "and 67 and is bitwise the sender-order fold there, equals the sparse Q-wide kernel "
        "on the compacted buffers bitwise, plus_times reproducible")
    structural = int((xchg["recv_rows"] < nl).sum())
    packed_time_row(torch, dev, "packed_scatter_combine_multi", words, val_x, n_out,
                    dict(kw, semiring="plus_times", senders=b), structural, rows)
    del val_x

    fam = FAMILIES["rwr"]
    step = make_batched_step(fspec, fmeta["cfg"], delta_kind=fam.delta_kind)
    restart = np.stack([part.to_blocked(fam.ctx_columns(n, r.query)["restart"])
                        for r in results[:64]], axis=-1)
    ctx = {"restart": torch.from_numpy(np.ascontiguousarray(restart)).to(dev)}
    active = torch.ones(64, dtype=torch.bool, device=dev)

    def three(v=v_state):
        for _ in range(3):
            v, deltas, _ = step(matrix, v, ctx, fmask, active)
            deltas.tolist()
    prof = device_breakdown(torch, three, 3)
    log(f"profile packed serve rwr (3 batched iterations, Q=64): {json.dumps(prof)}")
    srv.close()
    del matrix, v_state, ctx, eng
    torch.cuda.empty_cache()


def packed_widths_phase(torch, np, dev, gen):
    """Both packed kernels at the four device widths: random sorted sets of
    b = 8 senders padded with the sentinel, n_local at the top of each
    width's domain, every semiring, single-vector and Q = 64 / 67, against
    the plain versions and bitwise against the sparse kernels fed the same
    rows as int32 indices."""
    from repro_torch.exchange import codec, plan
    from repro_torch.kernels import scatter_combine

    rng = np.random.default_rng(7)
    b = 8
    for width, nl in ((4, 15), (8, 255), (16, 65535), (32, 131072)):
        if codec.device_width(nl) != width:
            raise SmokeError(f"device_width({nl}) is {codec.device_width(nl)}, not {width}")
        k = 32 // width
        p_cap = min(nl, 4096)
        p = -(-p_cap // k) * k
        sets = np.full((b, b, p), nl, np.int64)
        for s in range(b):
            for j in range(b):
                c = int(rng.integers(0, p_cap + 1))
                sets[s, j, :c] = np.sort(rng.choice(nl, c, replace=False))
        plan.check_sorted_rows(sets, nl)   # the layout the packed kernel searches
        words = torch.from_numpy(codec.pack_uniform(sets, width).reshape(-1)).to(dev)
        idx = torch.from_numpy(sets.astype(np.int32)).to(dev)
        pad = idx >= nl
        kw = dict(set_slots=b * p, n_local=nl, width=width)
        n_out = b * (nl + 1)
        for sr, dt in PACKED_SWEEP:
            s_spec = semiring_spec(np, sr, dt)
            for nq in (None, 64, 67):
                shape = (b, b, p) + (() if nq is None else (nq,))
                vv = rand_values(torch, gen, dev, shape, s_spec)
                vv.masked_fill_(pad if nq is None else pad[..., None], s_spec.identity)
                if nq is None:
                    got = scatter_combine.packed_scatter_combine_gimv(
                        words, vv.reshape(-1), n_out, semiring=sr, senders=b, **kw)
                    want = scatter_combine.packed_scatter_combine_ref(
                        words, vv.reshape(-1), n_out, semiring=sr, **kw)
                    sparse = scatter_combine.scatter_combine_gimv(idx, vv, nl, semiring=sr)
                else:
                    got = scatter_combine.packed_scatter_combine_gimv_multi(
                        words, vv.reshape(-1, nq), n_out, semiring=sr, senders=b, **kw)
                    want = scatter_combine.packed_scatter_combine_multi_ref(
                        words, vv.reshape(-1, nq), n_out, semiring=sr, **kw)
                    sparse = scatter_combine.scatter_combine_gimv_multi(idx, vv, nl,
                                                                        semiring=sr)
                what = f"packed width {width} {sr} {dt} Q={nq}"
                compare(torch, got, want, sr, what)
                seg = got.reshape((b, nl + 1) + (() if nq is None else (nq,)))[:, :nl]
                if not torch.equal(seg, sparse):
                    raise SmokeError(f"{what}: differs from the sparse kernel")
        rv = torch.rand((b * b * p, 64), generator=gen, device=dev)
        if not torch.equal(
                scatter_combine.packed_scatter_combine_gimv_multi(
                    words, rv, n_out, semiring="plus_times", senders=b, **kw),
                scatter_combine.packed_scatter_combine_gimv_multi(
                    words, rv, n_out, semiring="plus_times", senders=b, **kw)):
            raise SmokeError(f"packed width {width}: plus_times is not reproducible")
        log(f"kernels packed width {width} (n_local {nl}, {b}x{b}x{p} slots, "
            f"{int((~pad).sum())} structural): both packed kernels match their plain versions "
            "and the sparse kernels bitwise for 4 semirings, single and Q=64/67")


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
    warnings.filterwarnings("ignore", message="index_reduce")
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
        return res, meta, counts

    def ell_sweep(label, fp, v_flat, main_semiring, has_w_semirings):
        """Every bucket with the run's semiring, on the run's own vector and
        on a uniform random one, and across all four semirings (+ int32
        min_src) on random vectors; plus_times the same bits twice."""
        n_src = v_flat.shape[0]
        v_rand = rand_v(n_src, v_flat.dtype)
        sweep = [(sr, dt, rand_v(n_src, dt)) for sr, dt in (
            ("plus_times", torch.float32), ("min_plus", torch.float32),
            ("max_plus", torch.float32), ("min_src", torch.float32), ("min_src", torch.int32))]
        for i, bk in enumerate(fp.buckets):
            w = bk.w if main_semiring in has_w_semirings else None
            for which, v in (("run v", v_flat), ("random v", v_rand)):
                got = ell_spmv.ell_gimv(bk.cols, w, v, semiring=main_semiring)
                want = ell_spmv.ell_gimv_ref(bk.cols, w, v, semiring=main_semiring)
                compare(torch, got, want, main_semiring,
                        f"{label} ell bucket {i} {tuple(bk.cols.shape)} {which}")
            for semiring, dtype, v in sweep:
                got = ell_spmv.ell_gimv(bk.cols, bk.w, v, semiring=semiring)
                want = ell_spmv.ell_gimv_ref(bk.cols, bk.w, v, semiring=semiring)
                what = f"{label} ell bucket {i} {semiring} {dtype} {tuple(bk.cols.shape)}"
                compare(torch, got, want, semiring, what)
                if semiring == "plus_times" and not torch.equal(
                        got, ell_spmv.ell_gimv(bk.cols, bk.w, v, semiring=semiring)):
                    raise SmokeError(f"{what}: not the same bits twice")
        log(f"kernels {label}: ell_gimv matches its plain version on {len(fp.buckets)} buckets "
            "(run and random v) for 4 semirings and int32; plus_times the same bits twice")

    # -- run 1: PageRank, selective (horizontal at this density) ----------------
    eng = PMVEngine(edges, n, b=b, strategy="selective", backend="auto", device=dev)
    spec = pagerank(n)
    res, meta, _ = drive("pagerank/selective", eng, spec, max_iters=100, tol=1e-6,
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
    ell_sweep("pagerank", fp, v_flat, "plus_times", ("plus_times", "min_plus", "max_plus"))
    ell_bucket_times(torch, "pagerank", fp.buckets, v_flat, rows["ell_gimv"])
    del eng, fp, v_flat
    torch.cuda.empty_cache()

    # -- run 2: SSSP, vertical with the scatter-combine kernel -----------------
    eng = PMVEngine(edges, n, b=b, strategy="vertical", backend="auto", scatter="kernel",
                    stream="off", device=dev)
    spec = sssp(0)
    res, meta, _ = drive("sssp/vertical", eng, spec, max_iters=100, tol=0.5,
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
    res, meta, _ = drive("cc/hybrid", eng, spec, max_iters=100, tol=0.5,
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

    # -- run 4: PageRank, vertical, packed exchange with the packed kernel -----
    eng = PMVEngine(edges, n, b=b, strategy="vertical", backend="auto", scatter="kernel",
                    exchange="packed", delta_eps=0.0, device=dev)
    spec = pagerank(n)
    res, meta, counts = drive("pagerank/vertical packed", eng, spec, max_iters=100, tol=1e-6,
                              expect=("ell_gimv", "packed_scatter_combine"))
    if counts["scatter_combine"] != 0:
        raise SmokeError("pagerank/vertical packed: the sparse scatter kernel launched "
                         f"{counts['scatter_combine']} times on the packed path")
    want = pagerank_ref(np, sp, edges, n, res.iterations)
    ok = np.allclose(res.v, want, rtol=1e-4, atol=1e-12)
    rel = float(np.max(np.abs(res.v - want) / np.maximum(want, 1e-30)))
    log(f"check packed pagerank vs scipy power iteration ({res.iterations} iters): "
        f"max rel err {rel:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("packed pagerank disagrees with scipy")
    packed_run_checks(torch, np, dev, gen, eng, spec, res, meta, rows)
    v_local = torch.from_numpy(meta["part"].to_blocked(res.v.astype(np.float32)).copy()).to(dev)
    ell_sweep("pagerank packed", eng.prepare(spec)[0]["planned"], v_local.reshape(-1),
              "plus_times", ("plus_times", "min_plus", "max_plus"))
    del eng, v_local
    torch.cuda.empty_cache()

    # -- serve: PMVServer, hybrid theta=3000, 96 RWR + 96 SSSP queries at Q=64 ---
    rwr_answers = serve_phase(args.seed, torch, np, sp, csgraph, dev, gen, edges, n, b, 3000.0,
                              rows, failures)
    # -- packed serve: the same 96 RWR queries through the packed exchange -------
    packed_serve_phase(torch, np, dev, gen, edges, n, b, 3000.0, rwr_answers, rows, failures)
    del rwr_answers
    packed_widths_phase(torch, np, dev, gen)

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
