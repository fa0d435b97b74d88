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
              The three engines are built with ``obs=Recorder()``
              (``repro_torch.obs``): a "prepare phases" line per run gives
              the seconds of each ``prepare.*`` span (partition, stripes,
              plan, pack, device_put; stripes and pack include their
              host-to-device copies), their sum against ``prepare_s`` and
              the uncovered remainder; each run's Chrome trace goes through
              a file and back and must pass ``validate_chrome_trace`` and
              ``check_span_nesting``.  On the SSSP engine (prepare cached)
              the solve runs again 3 times with the recorder swapped off
              (``NULL_RECORDER``) and 3 times on, alternating: every answer
              and delta trajectory must be bitwise the traced run's; an
              "obs overhead" line prints both iteration medians and their
              ratio.  Then ``eng.explain(spec, live=True)`` is printed.
              Also on the SSSP engine, after its kernel checks:
              ``repro_torch.obs.profile_block_launches(eng, spec,
              repeats=3)`` packs every non-skip planned block alone and
              launches it under ``launch.ell`` / ``launch.dense`` spans:
              the span counts must be the plan's non-skip blocks x 3; right
              after each block's first launch (outside the spans) it is
              launched once more between CUDA events, and that first
              launch's outputs must equal the plain version on the same
              tables bucket by bucket (exact at min_plus).  Prints
              ``calibration_summary`` per kind (measured / predicted, ratio
              median), the per-block ratios (their spread, the largest and
              the smallest block), the host seconds of the per-block packs,
              the spans' and the events' ms over one pass and, on a line of
              their own, the profiler's kernel launches (not added to the
              main path's).
4. kernels -- after each run, the kernels it launched are called on the
              run's own inputs (every ELL bucket; the exchange buffers; the
              dense region) and held against their plain PyTorch versions
              for all four semirings (plus int32 for min_src): exact for
              min_plus / max_plus / min_src, rtol 1e-5 / atol 1e-6 for
              plus_times (the summation order differs; atol scales down with
              data below 1), which must also give the same bits twice.
              Every ELL bucket is also run on a uniform random vector.
              The SSSP run's scatter (kernel 3) is also held, on every
              case, bitwise against a plain fold in sender order, timed
              (min_plus on the run's values against ``index_reduce_`` at
              the valid slots and ``scatter_reduce`` over every slot;
              plus_times on random values against ``index_add_`` at the
              valid slots) and profiled: one device launch per call.
              These launches are outside the counted runs.  Kernel,
              plain-version and library times are CUDA-event means.  The
              PageRank run times ``ell_gimv`` on every bucket of one
              iteration ("bucket" lines: shape, occupancy, longest row,
              kernel and CSR ``torch.mv`` ms, the valid-slot and layout
              bounds; first asserting every row left-packed, the ELL
              kernels' precondition) and prints their sum.
   Each run is also profiled for 3 more iterations (torch.profiler): device
   time per iteration by kernel, host wall per iteration, idle share.
4b. bf16   -- after run 4 (``repro_torch.faults`` layer, the resident leg):
              ``PMVEngine(strategy='vertical', backend='auto',
              scatter='kernel', payload_dtype='bfloat16')`` runs PageRank 20
              iterations at tol 0, then on the same engine 10 iterations
              checkpointed every 5 and resumed to 20: the resumed answer
              must be bitwise the uninterrupted one, its max relative error
              against scipy's float64 power iteration at most 1e-2, and each
              iteration's ``exchange_payload_bytes`` exactly half the float32
              wire's (``exchange_wire_split`` at itemsize 2 against 4);
              ``ell_gimv`` and ``scatter_combine`` must launch.  A
              "checkpoint save" line times one save's legs (the 4 MiB
              blocked v to the host, ``np.savez``, ``os.replace``) against
              the median iteration.
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
              answer and iteration count bitwise phase 5's.  This server runs
              with ``telemetry=TelemetryConfig(latency_target_s=30,
              serve=True, host='127.0.0.1', port=0)``: its live snapshot must
              count 96 retirements and the SLO 96 latency events, a GET of
              ``<url>/metrics`` must show ``pmv_serve_retired_total 96.0``,
              ``repro_torch.cli.main(["obs", "top", url, "--count", "1"])``
              must return 0 (its frame is printed), and ``srv.close()`` must
              stop the exporter's thread.  Kernels, outside
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
7. disk    -- the out-of-core store (``repro_torch.store``): the directed edges
              of phase 2 ingested at b = 8, with the θ-split shards of
              theta=3000, into a temporary directory (its free space printed
              first; removed at the end) and audited (``verify_store``), then
              five ``PMVEngine(residency='disk', backend='auto')`` solves
              under a residency budget of two weighted block slices (below
              one striping's shard bytes; each hybrid leg holds its own):
              SSSP from 0 (strategy='vertical', scatter='kernel', to
              convergence; equal to scipy and to run 2), PageRank horizontal
              and PageRank vertical over the packed exchange
              (scatter='kernel'), 10 iterations each at tol 0 (rtol 1e-4
              against a 10-iteration scipy power iteration), and the same
              SSSP and PageRank with strategy='hybrid', theta=3000,
              scatter='kernel' (the dense leg per source block, the sparse
              leg per destination block, each off its own prefetch
              pipeline).  Then ``PMVServer(store=..., residency='disk',
              strategy='hybrid')`` serves the first 16 SSSP sources of phase
              5 (one Q = 16 batch; each answer equal to phase 5's, 4 also to
              scipy) and its first 8 RWR sources at 10 iterations (one Q = 8
              batch; rtol 1e-4 against scipy).  The launch counters are
              zeroed before each solve and the serve and read after:
              ``scatter_combine`` (on both SSSP solves and the hybrid
              PageRank), ``packed_scatter_combine`` and
              ``scatter_combine_multi`` must launch on the disk path.
              After each run that folds its tail with kernel 3 or 6, one
              more sparse-leg pass over the run's answers yields the
              (idx, val) the tail receives at that path's shapes (cap
              80,213 on the hybrid, Q = 16 and 8 on the serve); the kernel
              is held there against its plain version (bitwise for
              min_plus, rtol 1e-5 for plus_times) and, bitwise, the
              sender-order fold, and its error goes into the kernel row's
              ``disk_checks``.
              Prints per run the store's I/O split (fetch, wait, compute,
              overlap; the store fits in RAM, so its reads come from the
              page cache), bytes read per iteration over both hybrid legs,
              each leg's host double buffer against the budget, its device
              double buffer and its own fetch, wait and overlap, and the
              peak device memory beside the resident run's; for the serve
              also queries/s and the median batched-iteration wall.  Fails
              if a leg's peak host bytes pass the budget or a prefetch
              thread degraded.  The two SSSP solves and the serve are
              traced (``obs=Recorder()``): after each, ``store.bytes_read``
              must equal the run's ``store_bytes_read`` plus each leg's one
              fetch in flight, the serve's ``serve.query_latency_s`` must
              count exactly its retired queries, the trace must validate and
              nest, and "calibration" lines print ``calibration_summary``
              per kind (``disk_block``: a block body, predicted from the
              plan's slot cost at the data-sheet ``SLOT_TIME_S``, none on
              the hybrid's structural schedule; ``disk_io``: a slice read at
              ``DISK_READ_BW``): launches, measured and predicted ms, their
              ratio and the measured seconds per slot.
              Fault tolerance, on the same store and budget: the chaos disk
              SSSP (strategy='vertical', scatter='kernel') under a plan seeded
              from ``--seed`` -- a corrupt seg and a corrupt gat slice,
              TransientIO twice on one block, a 50 ms straggler, a broken
              prefetch thread (the rest of the run fetches synchronously)
              and a kill before iteration 3 -- checkpointed every iteration:
              it must raise ``InjectedKill``, and the resume on the same
              engine must be bitwise the clean disk SSSP and scipy with
              equal iterations, every fault fired (``fault.injected.<kind>``
              equal to ``plan.counts()``), ``store.verify_failures`` equal to
              the corrupt count and ``store.prefetch_degraded`` 1.  The
              overflow retry: the same solve at ``capacity='model',
              slack=0.01`` must report ``totals['fallback'] ==
              'structural_capacity'`` and ``pmv.fallbacks`` 1, bitwise the
              clean answer.  After the disk serve, the chaos disk serve: the
              first 4 SSSP sources of phase 5 at Q = 4 through the hybrid
              disk server with ``faults=`` one corrupt gat slice and one
              transient I/O error, bitwise phase 5's answers, both faults
              recovered (``fault.recovered`` 2).  Kernel 3 (chaos and
              overflow) and kernel 6 (chaos serve) launch counts join the
              disk launches.
              Fleet and CLI, before the chaos runs: ``fleet_report`` of the
              two traced disk SSSP solves (one worker, no straggler; skew
              and the measured against the modeled prefetch overlap
              printed), ``merge_traces`` of each one's recorder (schema
              valid, spans nest), then ``repro_torch.cli.main``: ``store
              verify`` on the store, ``obs report`` on a ``BENCH_obs.json``
              carrying the vertical solve's fleet report, and ``obs merge``
              over the Chrome traces of runs 1-3 (validated, one lane per
              input), each returning 0.
7b. spmd   -- the SPMD path, one rank per worker through torch.distributed.
              (a) NCCL, one rank in this process (``init_process_group(
              'nccl', world_size=1)`` on a file store): an SSSP from 0 over a
              size-1 DeviceMesh at b = 1 on RMAT-16, equal to scipy and
              bitwise the emulated b = 1 engine; one rank moves no bytes, it
              shows that NCCL takes the port's tensors.  (b) gloo, 8 ranks
              sharing the card (NCCL refuses two ranks on one GPU), each a
              subprocess of this script (``--spmd-rank R --spmd-dir D``)
              that runs the kernels on the card on its own worker's rows, on
              the graph of phase 2: the SSSP of run 2 (strategy='vertical',
              scatter='kernel'), bitwise run 2's answer and its
              per-iteration ``exchanged_elems``; PageRank horizontal within
              rtol 1e-4 of scipy.  On RMAT(scale - 2) (every rank runs the
              whole host prepare, so these two are cut to fit the time
              limit): the SSSP through ``exchange='hier'`` on a (2, 4)
              ('pod', 'workers') mesh, equal to scipy, its
              ``inter_pod_elems`` the closed form P(P-1)·W·n_local and below
              the flat sparse exchange's at the same capacity;
              ``PMVServer(mesh=..., strategy='hybrid', theta=3000,
              scatter='kernel')`` on the first 8 RWR sources of phase 5 (mod
              n) in one Q = 8 batch, within rtol 1e-4 of scipy.  Each rank zeroes its launch counters before each
              run and reads them after; the summed counts join the kernel
              rows, and each run's kernels must launch.  Prints each rank's
              median iteration wall and the phase's seconds: gloo stages
              the card's tensors through host memory, so no SPMD speed
              (NCCL, NVLink) can be read from them.
8. stream  -- the bucket-streamed planned executor (``stream='on'``, one
              destination block at a time) on ``erdos_renyi(2**s, 16 * 2**s)``
              with s = scale - 1 (cut from scale to fit the time limit) at
              b = 64 workers, cyclic psi: a uniform sparse
              graph at the paper's regime of many workers, where the default
              ``stream='auto'`` streams.  Run 1: SSSP from 0,
              ``PMVEngine(strategy='vertical', backend='auto',
              scatter='kernel')`` with the default stream: the plan must say
              'on' (its memory profile printed), the answer must equal scipy,
              and ``ell_gimv`` must launch exactly the launch schedule's
              non-empty (block, bucket) pairs each iteration, with one
              ``scatter_combine`` launch an iteration.  Run 2: the same solve
              with ``stream='off'``, bitwise run 1; each run's peak bytes
              above the resident matrix and state are printed beside
              ``memory_profile()``'s ratio, and the streamed one must be
              lower.  Run 3: ``PMVServer(strategy='vertical',
              backend='auto', scatter='kernel')`` serves 64 RWR queries (c
              0.85, tol 1e-6) in one Q = 64 batch through the streamed Q-wide
              executor: the family's plan says 'on', every query retires
              completed and converged, 8 answers lie within rtol 1e-4 of a
              scipy power iteration of their own iteration count,
              ``ell_gimv_multi`` and ``scatter_combine_multi`` launch and the
              single-vector kernels do not.  Then kernels 1 and 3 (run 1's
              state) and 5 and 6 (the served state) are held against their
              plain versions on every (block, bucket) view and on the
              compacted buffers the streamed executor builds (selection
              semirings exactly, plus_times at rtol 1e-5 and the same bits
              twice, kernels 3 and 6 bitwise the sender-order fold); the
              errors go into the kernel rows' ``stream_checks``.
9. summary -- the card, a ``{"kernels": [...]}`` line (eight kernels), and last
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
                  ("packed_scatter_combine_tile", "packed_scatter_combine"),
                  ("ell_gimv_kernel", "ell_gimv"), ("ell_gimv_wide_kernel", "ell_gimv"),
                  ("dense_gimv_kernel", "dense_gimv"),
                  ("scatter_combine_tile", "scatter_combine"),
                  ("ell_gimv_multi_kernel", "ell_gimv_multi"),
                  ("ell_gimv_multi_wide_kernel", "ell_gimv_multi"),
                  ("ell_gimv_multi_half_kernel", "ell_gimv_multi"),
                  ("dense_gimv_multi_kernel", "dense_gimv_multi"),
                  ("dense_gimv_multi_tf32x3", "dense_gimv_multi"),
                  ("scatter_multi_tile", "scatter_combine_multi"))


def device_breakdown(torch, run, iters: int) -> dict:
    """Profile ``run()`` (``iters`` solver iterations) with torch.profiler:
    device time per iteration of this package's kernels and of every other
    device op, the host wall per iteration, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()

    def markers():
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # late in a long process the trace can miss a window's first device
        # events and drop some near its end (a short window's all of them):
        # open and close it on markers (torch.cuda._sleep) that no sum
        # reads, and keep it open past them
        markers()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        markers()
        time.sleep(0.5)
    per: dict[str, float] = {}
    launches: dict[str, int] = {}
    top: dict[str, float] = {}
    host: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host[evt.key[:50]] = evt.self_cpu_time_total / 1e3 / iters
            continue
        if "spin_kernel" in evt.key:   # torch.cuda._sleep: the window's markers
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


def graph_nodes(torch, fn) -> dict:
    """The device work of one call of ``fn``, by node type ("kernel",
    "memcpy", "memset", ...), from that call captured in a CUDA graph: a
    capture records every launch, copy and fill the call enqueues, where the
    profiler's trace can drop some."""
    import ctypes

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    rc = rc or cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    kinds: dict[str, int] = {}
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        rc = rc or cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        name = {0: "kernel", 1: "memcpy", 2: "memset"}.get(t.value, f"type {t.value}")
        kinds[name] = kinds.get(name, 0) + 1
    del graph
    if rc:
        raise SmokeError(f"reading a captured CUDA graph's nodes failed: CUresult {rc}")
    return kinds


def profiled_calls(torch, fn, cls: str, calls: int = 20) -> tuple[float, float, dict]:
    """Device launches and device ms per call of ``fn`` for the kernel class
    ``cls`` (or of every device op when ``cls`` is "all"); also its launches
    by class.  The device ms is read from :func:`device_breakdown` over
    ``calls`` calls.  Late in a long process the trace drops kernel events
    (1-2 of 20, in every window alike), though it never adds one, so for a
    class the launches per call come from one call captured in a CUDA graph
    (:func:`graph_nodes`): its kernel nodes, with every node that is not a
    kernel counted as well.  The trace must then show that class and no
    other, never more than once a call; of up to eight windows the one that
    caught the most launches is read, and each window's count is listed."""
    best, caught = None, []
    for _ in range(8):
        prof = device_breakdown(torch, lambda: [fn() for _ in range(calls)], calls)
        launches = prof["device_launches"]
        n = sum(launches.values()) if cls == "all" else launches.get(cls, 0)
        caught.append(n)
        if best is None or n > best[0]:
            best = (n, prof)
        if cls != "all" and n == calls:
            break
    n, prof = best
    seen = dict(prof["device_launches"], windows_caught=caught)
    if cls == "all":
        return n / calls, prof["device_ms_per_iter"], seen
    if set(prof["device_launches"]) != {cls} or n > calls:
        raise SmokeError(f"{cls}: the profiler saw {json.dumps(seen)} over {calls} calls, "
                         f"not {cls} alone at most once a call")
    nodes = graph_nodes(torch, fn)
    seen["graph_nodes_per_call"] = nodes
    per_call = nodes.get("kernel", 0) + sum(v for k, v in nodes.items() if k != "kernel")
    return per_call, prof["by_kernel_ms"][cls], seen


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
    Returns the answers on the host by family ('rwr', 'sssp'), in submission
    order, each as (source, vector, iterations), and the serve's peak GiB."""
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
    return {kind: [(r.query.source, r.vector, r.iterations) for r in by_kind[kind]]
            for kind in ("rwr", "sssp")}, peak


# ---------------------------------------------------------------------------
# packed exchange phases

PACKED_SWEEP = (("plus_times", "float32"), ("min_plus", "float32"), ("max_plus", "float32"),
                ("min_src", "float32"), ("min_src", "int32"))


def sparse_scatter_phase(torch, dev, gen, n, idx_x, val_x, nl, rows) -> None:
    """Kernel 3 on the SSSP run's compacted buffers (idx_x, val_x [S, B, cap]):
    against its plain version and, bitwise, the sender-order fold for 4
    semirings and int32 min_src (plus_times within tolerance of the plain
    version, and the same bits twice); its times and bound into
    ``rows["scatter_combine"]``."""
    from repro_torch.kernels import scatter_combine

    s_, b_, cap = idx_x.shape
    rows_x = sparse_rows(torch, idx_x, nl)
    errs = []

    def rand():
        return torch.rand(val_x.shape, generator=gen, device=dev)

    for semiring, vv in (("min_plus", val_x), ("plus_times", rand()), ("max_plus", rand()),
                         ("min_src", rand()),
                         ("min_src", torch.randint(0, n, val_x.shape, generator=gen, device=dev,
                                                   dtype=torch.int32))):
        got = scatter_combine.scatter_combine_gimv(idx_x, vv, nl, semiring=semiring)
        wnt = scatter_combine.scatter_combine_ref(idx_x, vv, nl, semiring=semiring)
        what = f"scatter {semiring} {vv.dtype} {tuple(idx_x.shape)}"
        errs.append(compare(torch, got, wnt, semiring, what))
        check_sender_order(torch, got, rows_x, vv[..., None], s_ * nl, semiring, what)
    del rows_x
    # plus_times is the same bits from run to run (fixed sender order)
    rv = rand()
    r1 = scatter_combine.scatter_combine_gimv(idx_x, rv, nl, semiring="plus_times")
    r2 = scatter_combine.scatter_combine_gimv(idx_x, rv, nl, semiring="plus_times")
    if not torch.equal(r1, r2):
        raise SmokeError("scatter_combine plus_times is not reproducible run to run")
    log(f"kernels sssp: scatter_combine matches its plain version at {list(idx_x.shape)} "
        "for 4 semirings and int32, bitwise the sender-order fold for each; plus_times "
        "bitwise reproducible")
    # times: min_plus on the run's values against index_reduce_ at the valid
    # slots (and PR 16's yardstick, scatter_reduce over every slot),
    # plus_times on random values against index_add_ at the valid slots;
    # profiled, one device launch per call
    keep = (idx_x < nl).reshape(-1)
    flat_all = idx_x.reshape(s_, -1).to(torch.int64)
    flat_all = (torch.where(flat_all < nl, flat_all, nl)
                + torch.arange(s_, device=dev)[:, None] * (nl + 1)).reshape(-1)
    flat = sparse_rows(torch, idx_x, nl).reshape(-1)[keep]
    n_valid = int(keep.sum())
    times = {}
    for sr, vv in (("min_plus", val_x), ("plus_times", rv)):
        call = lambda vv=vv, sr=sr: scatter_combine.scatter_combine_gimv(  # noqa: E731
            idx_x, vv, nl, semiring=sr)
        ms = time_ms(torch, call, 20)
        plain_ms = time_ms(torch, lambda vv=vv, sr=sr: scatter_combine.scatter_combine_ref(
            idx_x, vv, nl, semiring=sr), 20)
        fval = vv.reshape(-1)[keep]
        if sr == "min_plus":
            base = torch.full((s_ * nl,), float("inf"), device=dev)
            lib_call = lambda base=base, fval=fval: base.clone().index_reduce_(  # noqa: E731
                0, flat, fval, "amin")
            lib_name = "index_reduce_"
        else:
            base = torch.zeros((s_ * nl,), device=dev)
            lib_call = lambda base=base, fval=fval: base.clone().index_add_(  # noqa: E731
                0, flat, fval)
            lib_name = "index_add_"
        lib_ms = time_ms(torch, lib_call, 20)
        compare(torch, call(), lib_call().reshape(s_, nl), sr, f"scatter vs {lib_name}")
        per_call, dev_ms, seen = profiled_calls(torch, call, "scatter_combine")
        if per_call != 1:
            raise SmokeError(f"scatter_combine {sr}: {per_call} device launches per call, not 1 "
                             f"(launches by class over 20 calls: {json.dumps(seen)})")
        times[sr] = dict(ms=ms, plain_ms=plain_ms, lib_ms=lib_ms, device_ms=dev_ms,
                         per_call=per_call, lib_name=lib_name)
        del base, fval, lib_call
    fval = val_x.reshape(-1)
    base = torch.full((s_ * (nl + 1),), float("inf"), device=dev)
    all_ms = time_ms(torch, lambda: base.clone().scatter_reduce_(0, flat_all, fval, reduce="amin"),
                     20)
    # the kernel reads a row's valid prefix only: each valid slot's index and
    # value once, the output written once
    b_ms, b_by = bound(n_valid * 4 + n_valid * 4 + s_ * nl * 4, n_valid)
    mp, pt = times["min_plus"], times["plus_times"]
    rows["scatter_combine"].update(
        max_abs_err=errs[0], ms=mp["ms"], plain_ms=mp["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, library_ms=mp["lib_ms"], semiring="min_plus", shape=[s_, b_, cap],
        n_local=nl, valid_slots=n_valid, device_launches_per_call=mp["per_call"],
        device_ms=mp["device_ms"], scatter_reduce_all_slots_ms=all_ms,
        plus_times_ms=pt["ms"], plus_times_device_ms=pt["device_ms"],
        plus_times_library_ms=pt["lib_ms"], plus_times_plain_ms=pt["plain_ms"])
    for sr, t in times.items():
        log(f"time scatter_combine {sr} {[s_, b_, cap]} n_local {nl} valid {n_valid}: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, {t['lib_name']} at the "
            f"valid slots {t['lib_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); profiler: "
            f"{t['per_call']:g} device launches per call, device {t['device_ms']:.4f} ms per "
            "call")
    log(f"time scatter_combine min_plus: scatter_reduce over all {s_ * b_ * cap} slots "
        f"{all_ms:.4f} ms")


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
    from repro_torch.obs import TelemetryConfig
    from repro_torch.serving import FAMILIES, PMVServer, Query, make_batched_step

    queries = [Query("rwr", source=int(src), c=0.85, tol=1e-6) for src, _, _ in rwr_answers]
    # live telemetry on, served over HTTP from an ephemeral port
    srv = PMVServer(edges, n, b=b, strategy="hybrid", theta=theta, backend="auto",
                    scatter="kernel", exchange="packed", stream="off", device=dev,
                    max_iters=200, telemetry=TelemetryConfig(latency_target_s=30.0, serve=True,
                                                             host="127.0.0.1", port=0))
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
    telemetry_checks("packed serve", srv, len(queries))

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
    telemetry_close_check("packed serve", srv)
    del matrix, v_state, ctx, eng
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# observability (repro_torch.obs)
# ---------------------------------------------------------------------------

def prepare_phases(label: str, rec, meta: dict) -> dict:
    """The ``prepare phases`` line of a traced solve: the seconds of each
    ``prepare.*`` span, their sum against ``meta['prepare_s']`` and the
    uncovered remainder (strategy / stream resolution, meta).  The spans run
    one after another inside prepare_s, so their sum cannot exceed it."""
    phases: dict[str, float] = {}
    for e in rec.spans("prepare."):
        key = e["name"][len("prepare."):]
        phases[key] = phases.get(key, 0.0) + e["dur"]
    total = sum(phases.values())
    prep = meta["prepare_s"]
    log(f"prepare phases {label}: "
        + " ".join(f"{k}={v:.3f}" for k, v in phases.items())
        + f" sum={total:.3f} prepare_s={prep:.3f} uncovered={prep - total:.3f} "
        f"({100.0 * (prep - total) / prep:.2f}%)")
    if not phases or total > prep + 1e-3:
        raise SmokeError(f"{label}: prepare spans {phases} do not fit in prepare_s {prep}")
    return phases


def check_trace(label: str, rec) -> int:
    """Write the recorder's Chrome trace to a file in the temporary
    directory, read it back (and remove it), validate its schema and its
    per-thread span nesting.  Returns the event count."""
    import os
    import tempfile

    from repro_torch.obs import check_span_nesting, validate_chrome_trace

    fd, path = tempfile.mkstemp(prefix="pmv_trace_", suffix=".json")
    os.close(fd)
    try:
        rec.write_chrome_trace(path)
        size = os.path.getsize(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.unlink(path)
    n = validate_chrome_trace(doc)
    check_span_nesting(doc)
    lanes = len({(e["pid"], e["tid"]) for e in doc["traceEvents"]})
    log(f"trace {label}: {n} spans on {lanes} lanes, {size} bytes: schema valid, spans nest")
    return n


def obs_overhead(torch, np, label: str, eng, spec, traced, *, max_iters, tol, reps=3) -> None:
    """The recorder's cost on a resident solve whose prepare is cached: the
    same solve with the recorder swapped off (``NULL_RECORDER``) and back on,
    alternating, ``reps`` times each.  Every run's answer and deltas must be
    bitwise the traced run's; prints the iteration medians and their ratio."""
    from repro_torch.obs import NULL_RECORDER

    rec = eng.obs
    walls = {"on": [], "off": []}
    try:
        for _ in range(reps):
            for mode in ("off", "on"):
                eng.obs = NULL_RECORDER if mode == "off" else rec
                res = eng.run(spec, max_iters=max_iters, tol=tol)
                torch.cuda.synchronize()
                if not (np.array_equal(res.v, traced.v)
                        and np.array_equal(res.deltas, traced.deltas)):
                    raise SmokeError(f"{label}: obs {mode} run is not bitwise the traced run")
                walls[mode] += [r["wall_s"] for r in res.per_iter]
    finally:
        eng.obs = rec
    on, off = float(np.median(walls["on"])), float(np.median(walls["off"]))
    log(f"obs overhead {label}: median iteration on {1e3 * on:.4f} ms, off {1e3 * off:.4f} ms, "
        f"on/off {on / off:.4f} ({len(walls['on'])} + {len(walls['off'])} iterations, "
        f"{reps} alternating runs each); v and deltas bitwise the traced run's")


def calibration_lines(label: str, rec) -> None:
    """Per kind (``disk_block``: a block body out of core; ``disk_io``: a
    shard-slice read), the launches, measured and predicted ms, their ratio
    and the measured seconds per predicted slot."""
    from repro_torch.obs import calibration_summary

    for kind, c in calibration_summary(rec).items():
        pred = c["predicted_s"]
        log(f"calibration {label} {kind}: launches={c['launches']} "
            f"measured_ms={1e3 * c['measured_s']:.3f} "
            + (f"predicted_ms={1e3 * pred:.6f} ratio={c['ratio']:.1f} "
               f"ratio_median={c['ratio_median']:.1f} " if pred > 0 else
               "predicted_ms=n/a (no plan: the structural schedule) ")
            + (f"measured_s_per_slot={c['measured_s_per_slot']:.4e} "
               if "measured_s_per_slot" in c else "")
            + (f"measured_bw_gb_s={c['measured_bw_bytes_per_s'] / 1e9:.3f}"
               if "measured_bw_bytes_per_s" in c else ""))


def profiler_phase(torch, np, label: str, eng, spec, *, repeats: int = 3) -> dict:
    """``repro_torch.obs.profile_block_launches`` on a prepared resident
    engine: every non-skip planned block packed alone and launched
    ``repeats`` times under its ``launch.ell`` / ``launch.dense`` span.  The
    span counts must be the plan's non-skip blocks times ``repeats``.  After
    each block's first launch (outside the spans) the block is launched once
    more between two CUDA events, then that first launch's outputs are held,
    bucket by bucket, against the plain version on the same tables and
    operand (exact but for plus_times).  Prints the calibration summary per
    kind, the per-block measured / predicted ratios (their spread, and the
    largest and the smallest block), the host seconds of the per-block
    packs, the spans' and the events' milliseconds over one pass, and the
    profiler's kernel launches (outside every main-path count)."""
    from repro_torch import kernels
    from repro_torch.kernels import block_gimv, ell_spmv
    from repro_torch.obs import calibration_summary, profile_block_launches

    plan = eng.prepare(spec)[-1]["plan"]
    semiring = block_gimv.semiring_of(spec.combine2, spec.combine_all)
    held = {"launch.ell": 0, "launch.dense": 0}
    errs, event_ms = [0.0], []

    def inspect(r):
        # timed first, right after the first launch, in the cache state the
        # spans see (the plain versions below would evict the tables)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        r["launch"]()
        end.record()
        end.synchronize()
        event_ms.append(start.elapsed_time(end))
        what = f"{label} profiled block ({r['attrs']['i']}, {r['attrs']['j']})"
        if r["name"] == "launch.dense":
            want = block_gimv.dense_gimv_ref(r["operands"], r["v"], semiring=semiring)
            errs.append(compare(torch, r["out"], want, semiring, f"{what} dense"))
        else:
            for k, ((cols, w), out) in enumerate(zip(r["operands"], r["out"])):
                want = ell_spmv.ell_gimv_ref(cols, w if spec.needs_weights else None, r["v"],
                                             semiring=semiring)
                errs.append(compare(torch, out, want, semiring,
                                    f"{what} bucket {k} {tuple(cols.shape)}"))
        held[r["name"]] += 1

    torch.cuda.synchronize()
    before = kernels.launch_counts()
    t = time.perf_counter()
    rec = profile_block_launches(eng, spec, repeats=repeats, inspect=inspect)
    wall = time.perf_counter() - t
    after = kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    tactics = plan.tactic_counts()
    want = {k: tactics[k.split(".")[1]] * repeats for k in held}
    spans = {k: len(rec.spans(k)) for k in held}
    if spans != want or not sum(held.values()):
        raise SmokeError(f"{label} profiler: spans {spans}, expected {want} (plan {tactics})")
    for kind, c in calibration_summary(rec).items():
        log(f"profile calibration {label} {kind}: launches={c['launches']} "
            f"measured_ms={1e3 * c['measured_s']:.3f} predicted_ms={1e3 * c['predicted_s']:.4e} "
            f"ratio={c['ratio']:.1f} ratio_median={c['ratio_median']:.1f} "
            f"predicted_slots={c['predicted_slots']:.0f} "
            f"measured_s_per_slot={c['measured_s_per_slot']:.4e}")
    # block -> (predicted s, median measured s over the repeats)
    per_block: dict = {}
    for e in rec.spans("launch."):
        a = e["attrs"]
        per_block.setdefault((a["i"], a["j"]), [a["predicted_s"]]).append(e["dur"])
    per_block = {k: (d[0], float(np.median(d[1:]))) for k, d in per_block.items()}
    ratios = sorted(m / p for p, m in per_block.values())
    big = max(per_block, key=lambda k: per_block[k][0])
    small = min(per_block, key=lambda k: per_block[k][0])
    span_ms = 1e3 * rec.total("launch.") / repeats

    def us(k):
        p, m = per_block[k]
        return f"{k} predicted {1e6 * p:.4g} us measured {1e6 * m:.2f} us ({m / p:.1f}x)"

    log(f"profiler {label}: all non-skip blocks: {held} x {repeats} repeats, spans {spans} == "
        f"the plan's x {repeats}; every bucket's first launch == its plain version (max |err| "
        f"{max(errs)}); per-block measured/predicted min {ratios[0]:.1f} median "
        f"{float(np.median(ratios)):.1f} max {ratios[-1]:.1f}; largest block {us(big)}, "
        f"smallest {us(small)}; host pack "
        f"{rec.total('profile.pack'):.3f} s; one pass: spans {span_ms:.3f} ms, CUDA events "
        f"{sum(event_ms):.3f} ms ({100.0 * sum(event_ms) / span_ms:.1f}% of the spans); "
        f"phase {wall:.1f} s")
    log(f"profiler launches {label} (outside the main path's counts): {json.dumps(launched)}")
    return {"spans": spans, "ratios": ratios, "event_ms": sum(event_ms), "span_ms": span_ms}


def telemetry_checks(label: str, srv, n_queries: int) -> None:
    """The server's live telemetry after it answered ``n_queries``: the
    snapshot's retired count and the SLO's latency events equal the
    queries, a GET of ``<url>/metrics`` shows the retired total, and
    ``python -m repro_torch obs top <url> --count 1`` returns 0 (its frame
    is printed).  A failed bind or scrape raises."""
    import urllib.request

    from repro_torch import cli

    tel = srv.telemetry
    if tel is None or tel.url is None:
        raise SmokeError(f"{label}: the telemetry exporter is not serving")
    snap = tel.snapshot()
    slo = srv.stats()["slo"]
    with urllib.request.urlopen(tel.url + "/metrics", timeout=30) as resp:
        body = resp.read().decode()
    line = f"pmv_serve_retired_total {float(n_queries)}"
    ok = (snap["retired"]["total_count"] == n_queries
          and slo["latency"]["total"]["events"] == n_queries and line in body.splitlines())
    log(f"telemetry {label}: {tel.url} retired {snap['retired']['total_count']} latency p50 "
        f"{snap['latency']['p50']} p99 {snap['latency']['p99']} s; slo latency events "
        f"{slo['latency']['total']['events']} bad {slo['latency']['total']['bad']} (target "
        f"{slo['latency']['target_s']} s) burn {slo['latency']['total']['burn_rate']}; "
        f"/metrics {len(body)} bytes with '{line}': {line in body.splitlines()} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeError(f"{label}: telemetry does not count the {n_queries} queries")
    rc = cli.main(["obs", "top", tel.url, "--count", "1"])
    if rc != 0:
        raise SmokeError(f"{label}: obs top returned {rc}")


def telemetry_close_check(label: str, srv) -> None:
    """``srv.close()`` must stop the exporter: its thread ends, its URL is
    gone."""
    thread = srv.telemetry._thread
    srv.close()
    thread.join(30)
    if thread.is_alive() or srv.telemetry.url is not None:
        raise SmokeError(f"{label}: close() left the telemetry exporter running")
    log(f"telemetry {label}: close() stopped the exporter's thread")


def fleet_cli_phase(root: str, solves: dict, traces: dict) -> None:
    """On the disk phase's store and runs: ``fleet_report`` of each traced
    disk solve (one worker, no straggler; skew and the measured against the
    modeled prefetch overlap printed), ``merge_traces`` of its recorder
    (schema valid, spans nest), then the CLI: ``store verify`` on the store,
    ``obs report`` on a ``BENCH_obs.json`` carrying the fleet report and
    ``obs merge`` over the traces of ``traces`` (label -> recorder), each
    returning 0; the merged trace must validate and nest, one lane per
    input lane."""
    import os

    from repro_torch import cli
    from repro_torch.obs import (bench_obs_doc, check_span_nesting, fleet_report, merge_traces,
                                 validate_chrome_trace, write_bench_obs)

    t = time.perf_counter()
    reports = {}
    for label, (res, rec) in solves.items():
        rep = fleet_report(res)
        if rep.workers != 1 or rep.stragglers:
            raise SmokeError(f"fleet {label}: {rep.workers} workers, stragglers "
                             f"{rep.stragglers}")
        ov, io = rep.overlap, rep.per_worker[0]
        log(f"fleet {label}: workers={rep.workers} iterations={len(rep.iterations)} "
            f"stragglers={rep.straggler_workers} skew median={rep.skew['median']:.4f} "
            f"max={rep.skew['max']:.4f}; overlap measured={ov['measured_mean']:.4f} "
            f"predicted={ov['predicted_mean']:.4f} (measured/predicted {ov['ratio']}); "
            f"fetch {io['io_s']:.3f} s wait {io['wait_s']:.3f} s over the run, modeled I/O "
            f"{sum(r['predicted_io_s'] for r in rep.iterations):.3f} s")
        doc = merge_traces(rec)
        n = validate_chrome_trace(doc)
        check_span_nesting(doc)
        lanes = len({(e["pid"], e["tid"]) for e in doc["traceEvents"] if e.get("ph") == "X"})
        log(f"fleet trace {label}: merge_traces {n} spans from {doc['otherData']['shards']} "
            f"shard(s) on {lanes} lanes: schema valid, spans nest")
        reports[label] = (rep, rec)
    rc = cli.main(["store", "verify", root])
    if rc != 0:
        raise SmokeError(f"store verify {root} returned {rc}")
    out_dir = os.path.join(root, "obs")      # inside the store's directory, after its audit
    os.makedirs(out_dir)
    label, (rep, rec) = next(iter(reports.items()))
    bench = os.path.join(out_dir, "BENCH_obs.json")
    write_bench_obs(bench, bench_obs_doc({label: rec}, fleet=rep.to_dict(),
                                         extra_launches=rep.calibration_launches()))
    rc = cli.main(["obs", "report", bench])
    if rc != 0:
        raise SmokeError(f"obs report {bench} returned {rc}")
    paths, lanes_in = [], 0
    for i, (name, trace_rec) in enumerate(traces.items()):
        paths.append(os.path.join(out_dir, f"trace{i}.json"))
        trace_rec.write_chrome_trace(paths[-1])
        with open(paths[-1]) as f:
            lanes_in += len({e["pid"] for e in json.load(f)["traceEvents"]})
    merged = os.path.join(out_dir, "merged.json")
    rc = cli.main(["obs", "merge", merged, *paths, "--labels", *traces])
    if rc != 0:
        raise SmokeError(f"obs merge returned {rc}")
    with open(merged) as f:
        doc = json.load(f)
    n = validate_chrome_trace(doc)
    check_span_nesting(doc)
    lanes = {e["pid"] for e in doc["traceEvents"]}
    if len(lanes) != lanes_in or doc["otherData"]["documents"] != len(traces):
        raise SmokeError(f"obs merge: {len(lanes)} lanes from {lanes_in} input lanes")
    log(f"cli: store verify, obs report (fleet {label}) and obs merge of {len(traces)} traces "
        f"({n} spans, {len(lanes)} lanes; schema valid, spans nest) returned 0; "
        f"{time.perf_counter() - t:.1f} s")


def check_store_counters(label: str, rec, executors, bytes_read: float) -> None:
    """``store.bytes_read`` counts every fetch; the run's records bill a
    slice when an iteration consumes it.  Each leg's pipeline holds one
    fetch in flight past the last iteration (the next iteration's first
    block): wait for it, then the counter must be the records' bytes plus
    those."""
    pending = 0.0
    for ex in executors:
        for leg in ex.legs:
            if leg.pipeline is not None and leg.pipeline._fut is not None:
                pending += float(leg.pipeline._fut[1].result()[0]["nbytes"])
    got = rec.counter("store.bytes_read").value
    ok = got == bytes_read + pending
    log(f"check {label} store.bytes_read {got:.0f} == the run's store_bytes_read "
        f"{bytes_read:.0f} + in-flight prefetch {pending:.0f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeError(f"{label}: store.bytes_read {got} != {bytes_read} + {pending}")


def disk_phase(torch, np, sp, csgraph, dev, edges, n, b, theta, sssp_resident, served,
               resident_peaks, rows, failures, *, seed=0, chaos_q=4, traces=None):
    """Phase 7 (see the module doc): ingest (with the θ-split shards of
    ``theta``), audit, five disk solves, the chaos disk SSSP and the overflow
    retry, the disk serve and the chaos disk serve (at Q = ``chaos_q``).
    ``sssp_resident`` is run 2's answer, ``served`` the resident serve's
    first 16 SSSP answers and first 8 RWR sources, ``resident_peaks`` the
    resident runs' and the serve's peak GiB by label, ``seed`` the chaos
    plans', ``traces`` (label -> recorder) the resident runs' recorders that
    ``obs merge`` merges in :func:`fleet_cli_phase`."""
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.core import PMVEngine, cost_model, pagerank, sssp
    from repro_torch.obs import Recorder
    from repro_torch.store import ingest_edges, verify_store

    root = tempfile.mkdtemp(prefix="pmv_store_")
    t_phase = time.perf_counter()
    try:
        usage = shutil.disk_usage(root)
        log(f"disk space at {root} before the ingest: total {usage.total / 1e9:.1f} GB, "
            f"free {usage.free / 1e9:.1f} GB")
        t = time.perf_counter()
        man = ingest_edges(edges, n, b, root, theta=theta)
        ingest_s = time.perf_counter() - t
        t = time.perf_counter()
        report = verify_store(root)
        verify_s = time.perf_counter() - t
        if not report.ok:
            raise SmokeError(f"disk: verify_store: {report.summary()}")
        striping = man.total_shard_bytes("vertical")
        # the least budget the store accepts: its double buffer of two
        # weighted block slices (at b = 8 that is 3/8 of one striping, so a
        # quarter of the striping could not hold it); each hybrid leg fits it
        budget = 2 * cost_model.stripe_slice_bytes(b, man.e_cap, has_w=True)
        log(f"disk store: ingest_s={ingest_s:.2f} (theta={theta}: the vertical and horizontal "
            f"stripings plus the hybrid pair) verify_s={verify_s:.2f} "
            f"digests={report.checked} m={man.m} e_cap={man.e_cap} hybrid={json.dumps(man.hybrid)} "
            f"bytes: {json.dumps({s: man.total_shard_bytes(s) for s in man.stripings()})} "
            f"budget_bytes={budget} (budget/striping {budget / striping:.4f}; "
            "reads from the page cache)")
        hybrid = dict(strategy="hybrid", theta=theta, scatter="kernel")
        traced_solves = {}
        solves = [
            ("sssp/vertical disk", dict(strategy="vertical", scatter="kernel"), sssp(0), 100,
             0.5, "scatter_combine", "sssp/vertical"),
            ("pagerank/horizontal disk", dict(strategy="horizontal"), pagerank(n), 10, 0.0,
             None, "pagerank/selective"),
            ("pagerank/vertical packed disk",
             dict(strategy="vertical", exchange="packed", scatter="kernel"), pagerank(n), 10,
             0.0, "packed_scatter_combine", "pagerank/vertical packed"),
            ("sssp/hybrid disk", hybrid, sssp(0), 100, 0.5, "scatter_combine", "sssp/vertical"),
            ("pagerank/hybrid disk", hybrid, pagerank(n), 10, 0.0, "scatter_combine",
             "pagerank/selective"),
        ]
        for label, kw, spec, max_iters, tol, kernel, resident in solves:
            # the SSSP solves are traced (their answers are held to the
            # untraced resident run's below)
            rec = Recorder() if spec.name == "sssp" else None
            eng = PMVEngine(None, store=root, residency="disk", backend="auto",
                            store_budget_bytes=budget, device=dev, obs=rec, **kw)
            _, _, _, _, meta = eng.prepare(spec)
            ex = meta["executor"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            res = eng.run(spec, max_iters=max_iters, tol=tol)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            it = res.per_iter

            def med(key, it=it):
                return float(np.median([r[key] for r in it]))

            log(f"disk {label}: exchange={meta['exchange']} scatter={ex.scatter} "
                f"iterations={res.iterations} converged={res.converged} "
                f"prepare_s={meta['prepare_s']:.3f} "
                f"median_iter_s={med('wall_s'):.4f} "
                f"store_io_s={med('store_io_s'):.4f} store_wait_s={med('store_wait_s'):.4f} "
                f"store_compute_s={med('store_compute_s'):.4f} "
                f"store_overlap={med('store_overlap'):.4f} "
                f"(io split: read {med('store_read_s'):.4f} verify {med('store_verify_s'):.4f} "
                f"weights {med('store_weights_s'):.4f} s, device copies "
                f"{med('store_h2d_s'):.4f} s; medians per iteration; totals "
                f"io {res.totals['store_io_s']:.3f} wait {res.totals['store_wait_s']:.3f} "
                f"compute {res.totals['store_compute_s']:.3f} s, overlap "
                f"{res.totals['store_overlap']:.4f}) "
                f"bytes_read_per_iter={med('store_bytes_read'):.0f} "
                f"blocks_fetched={med('store_blocks_fetched'):.0f} (page cache) "
                f"{disk_legs(ex, budget)} peak_gib={peak:.3f} "
                f"resident_peak_gib={resident_peaks[resident]:.3f} ({resident}) "
                f"launches={json.dumps({k: v for k, v in counts.items() if v})}")
            check_legs(label, ex, budget, failures)
            if kernel is not None:
                count_disk_launches(label, kernel, counts, rows)
            if label == "sssp/vertical disk":
                clean = (res.v, res.iterations, med("wall_s"))
            if spec.name == "sssp":
                want = sssp_ref(np, sp, csgraph, edges, n, 0)
                ok = (res.converged and np.array_equal(res.v.astype(np.float64), want)
                      and np.array_equal(res.v, sssp_resident))
                what = "scipy shortest_path and the resident run"
            else:
                want = pagerank_ref(np, sp, edges, n, res.iterations)
                ok = res.iterations == max_iters and np.allclose(res.v, want, rtol=1e-4,
                                                                 atol=1e-12)
                what = f"scipy power iteration ({res.iterations} iters)"
            log(f"check {label} vs {what} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{label} disagrees with {what}")
            if rec is not None:
                # before the tail check, whose extra pass records too
                check_store_counters(label, rec, [ex], res.totals["store_bytes_read"])
                calibration_lines(label, rec)
                check_trace(label, rec)
                traced_solves[label] = (res, rec)
            if kernel == "scatter_combine":
                disk_tail_check(torch, np, label, ex, res.v, rows)
            ex.close()
            del eng, meta, ex
            torch.cuda.empty_cache()
        fleet_cli_phase(root, traced_solves, traces or {})
        t = time.perf_counter()
        chaos_disk(torch, np, sp, csgraph, dev, edges, n, root, budget, seed, clean, rows,
                   failures)
        t_chaos = time.perf_counter() - t
        disk_serve(torch, np, sp, csgraph, dev, edges, n, root, theta, budget, served,
                   resident_peaks, rows, failures)
        t = time.perf_counter()
        chaos_serve(torch, np, dev, root, theta, budget, seed, served[0], rows, failures,
                    q=chaos_q)
        t_chaos += time.perf_counter() - t
        log(f"disk phase: {time.perf_counter() - t_phase:.1f} s (the chaos SSSP, the overflow "
            f"retry and the chaos serve {t_chaos:.1f} s)")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def disk_legs(ex, budget: int) -> str:
    """Each striping's host double buffer against the budget, its device
    double buffer, and its own fetch, wait and overlap over the executor's
    iterations so far.  (The summed store_overlap counts the hybrid's two
    legs' fetches, which their two threads run at once, as if they ran one
    after the other, so it is not the share of I/O hidden behind compute.)"""
    out = []
    for leg in ex.legs:
        st, run = leg.store, leg.run_stats()
        out.append(f"{st.striping}: peak_resident_bytes={st.peak_resident_bytes} "
                   f"budget_bytes={budget} device_buffer_bytes={st.device_buffer_bytes} "
                   f"io_s={run.io_s:.4f} wait_s={run.wait_s:.4f} "
                   f"overlap={run.overlap:.4f}")
    return " ".join(out)


def check_legs(label: str, ex, budget: int, failures: list) -> None:
    """A disk run fails on a degraded prefetch or on a leg's peak resident
    bytes outside the budget."""
    for st in (leg.store for leg in ex.legs):
        if st.prefetch_degraded:
            failures.append(f"{label}: the {st.striping} prefetch thread degraded to "
                            "synchronous fetches")
        if not 0 < st.peak_resident_bytes <= budget:
            failures.append(f"{label}: {st.striping} peak resident bytes "
                            f"{st.peak_resident_bytes} outside the budget {budget}")


def disk_tail_check(torch, np, label: str, ex, state, rows: dict) -> None:
    """Kernel 3 (or 6 for a batch) at the shapes a disk path gives it, on the
    (idx, val) its scatter tail receives: one more pass of the executor's
    sparse leg over ``state`` (the run's answer, [n] or [n, Q]) compacts
    them exactly as the run's iterations do, after the counted run.  The
    kernel is held against its plain version (bitwise for the selection
    semirings, rtol 1e-5 for plus_times) and, bitwise, against the
    sender-order fold; the error goes into the kernel row's ``disk_checks``."""
    from repro_torch.kernels import scatter_combine
    from repro_torch.kernels.block_gimv import semiring_of

    spec, nl = ex.spec, ex.part.n_local
    v = torch.from_numpy(np.ascontiguousarray(ex.part.to_blocked(state))).to(ex.store.device)
    ex._begin_iteration()
    idx, val, _, _ = ex._compact_blocks(v)
    del v
    idx, val = idx.contiguous(), val.contiguous()
    sr = semiring_of(spec.combine2, spec.combine_all)
    multi = val.ndim == idx.ndim + 1
    name, fn, ref = (
        ("scatter_combine_multi", scatter_combine.scatter_combine_gimv_multi,
         scatter_combine.scatter_combine_multi_ref) if multi else
        ("scatter_combine", scatter_combine.scatter_combine_gimv,
         scatter_combine.scatter_combine_ref))
    got = fn(idx, val, nl, semiring=sr)
    what = f"{label}: {name} {sr} on the tail's {tuple(val.shape)}"
    err = compare(torch, got, ref(idx, val, nl, semiring=sr), sr, what)
    check_sender_order(torch, got, sparse_rows(torch, idx, nl), val if multi else val[..., None],
                       idx.shape[0] * nl, sr, what)
    rows[name].setdefault("disk_checks", []).append(
        {"path": label, "shape": list(val.shape), "semiring": sr, "max_abs_err": err})
    log(f"kernels {label}: {name} {sr} on the tail's (idx, val) {list(val.shape)} "
        f"n_local {nl}: matches its plain version (max |err| {err}) and is bitwise the "
        "sender-order fold")
    del idx, val, got


def count_disk_launches(label: str, kernel: str, counts: dict, rows: dict) -> None:
    if counts[kernel] == 0:
        raise SmokeError(f"{label}: kernel {kernel} never launched on the disk path")
    rows[kernel]["launches"] += counts[kernel]
    rows[kernel]["disk_launches"] = rows[kernel].get("disk_launches", 0) + counts[kernel]


def disk_serve(torch, np, sp, csgraph, dev, edges, n, root, theta, budget, served,
               resident_peaks, rows, failures):
    """``PMVServer(store=root, residency='disk', strategy='hybrid')`` answers
    the resident serve's first 16 SSSP sources (one Q = 16 batch; each answer
    equal to the resident serve's, 4 also to scipy) and its first 8 RWR
    sources at 10 iterations (one Q = 8 batch; rtol 1e-4 against the scipy
    power iteration); kernel 6 must launch."""
    from repro_torch import kernels
    from repro_torch.obs import Recorder
    from repro_torch.serving import PMVServer, Query

    sssp_answers, rwr_sources = served
    rec = Recorder()
    srv = PMVServer(store=root, residency="disk", strategy="hybrid", theta=theta,
                    backend="auto", scatter="kernel", store_budget_bytes=budget, device=dev,
                    obs=rec)
    batches = [("sssp", [Query("sssp", source=int(s), tol=0.5) for s, _, _ in sssp_answers]),
               ("rwr", [Query("rwr", source=int(s), c=0.85, max_iters=10) for s in rwr_sources])]
    execs = {}
    for kind, qs in batches:
        eng, fspec = srv.engine_for(qs[0])
        meta = eng.prepare(fspec)[-1]
        execs[kind] = meta["executor"]
        log(f"disk serve family {kind}: prepare_s={meta['prepare_s']:.3f} strategy="
            f"{meta['strategy']} theta={meta['theta']} dense vertices={meta['n_dense']} "
            f"capacity={meta['capacity']} scatter={meta['executor'].scatter}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    results, before = {}, srv.stats()
    t_all = time.perf_counter()
    for kind, qs in batches:
        t = time.perf_counter()
        results[kind] = srv.serve(qs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        st = srv.stats()
        its = st["iterations"] - before["iterations"]
        walls = st["iter_wall_s"][-int(its):]

        def per_iter(key, st=st, its=its):
            return (st[key] - before[key]) / its

        ex = execs[kind]
        log(f"disk serve {kind}: {len(qs)} queries in {wall:.3f} s -> {len(qs) / wall:.3f} "
            f"queries/s; batches={st['batches'] - before['batches']} batched iterations="
            f"{int(its)} median_iter_s={float(np.median(walls)):.4f} per batched iteration: "
            f"store_io_s={per_iter('store_io_s'):.4f} store_wait_s={per_iter('store_wait_s'):.4f} "
            f"store_compute_s={per_iter('store_compute_s'):.4f} (io split: read "
            f"{per_iter('store_read_s'):.4f} verify {per_iter('store_verify_s'):.4f} weights "
            f"{per_iter('store_weights_s'):.4f} s, device copies {per_iter('store_h2d_s'):.4f} s) "
            f"bytes_read_per_iter={per_iter('store_bytes_read'):.0f} (page cache) "
            f"{disk_legs(ex, budget)}")
        check_legs(f"disk serve {kind}", ex, budget, failures)
        before = st
    serve_s = time.perf_counter() - t_all
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = srv.stats()
    log(f"disk serve: {sum(len(qs) for _, qs in batches)} queries in {serve_s:.3f} s; "
        f"store_overlap={st['store_overlap']:.4f} reasons={json.dumps(st['retirement_reasons'])} "
        f"peak_gib={peak:.3f} resident_serve_peak_gib={resident_peaks['serve']:.3f} "
        f"launches={json.dumps({k: v for k, v in counts.items() if v})}")
    count_disk_launches("disk serve", "scatter_combine_multi", counts, rows)
    check_store_counters("disk serve", rec, execs.values(), st["store_bytes_read"])
    lat = rec.histogram("serve.query_latency_s").to_dict()
    ok = lat["count"] == st["retired"] == sum(len(qs) for _, qs in batches)
    log(f"check disk serve serve.query_latency_s counts {lat['count']} == retired "
        f"{st['retired']} (p50 {lat['p50']:.3f} s, p99 {lat['p99']:.3f} s) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeError(f"disk serve: latency histogram counts {lat['count']}, "
                         f"retired {st['retired']}")
    calibration_lines("disk serve", rec)
    check_trace("disk serve", rec)
    bad = [r.qid for rs in results.values() for r in rs if r.reason != "completed"]
    if bad or st["batches"] != 2:
        failures.append(f"disk serve: {st['batches']} batches, queries not completed: {bad}")
    got = results["sssp"]
    ok = all(r.converged and r.iterations == it and np.array_equal(r.vector, v)
             for r, (_, v, it) in zip(got, sssp_answers))
    want = sssp_ref(np, sp, csgraph, edges, n, [r.query.source for r in got[:4]])
    ok = ok and all(np.array_equal(r.vector.astype(np.float64), want[j])
                    for j, r in enumerate(got[:4]))
    log(f"check disk serve sssp x{len(got)} vs the resident serve's answers and iteration "
        f"counts (x4 also scipy shortest_path) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("disk serve sssp disagrees with the resident serve or scipy")
    got = results["rwr"]
    want = rwr_ref(np, sp, edges, n, [r.query.source for r in got], [r.iterations for r in got])
    vec = np.stack([r.vector for r in got], axis=1)
    ok = all(r.iterations == 10 for r in got) and np.allclose(vec, want, rtol=1e-4, atol=1e-12)
    rel = float(np.max(np.abs(vec - want) / np.maximum(np.abs(want), 1e-30)))
    log(f"check disk serve rwr x{len(got)} vs scipy power iteration (10 iterations): "
        f"max rel err {rel:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("disk serve rwr disagrees with scipy")
    for kind, rs in results.items():
        disk_tail_check(torch, np, f"disk serve {kind}", execs[kind],
                        np.stack([r.vector for r in rs], axis=1), rows)
    srv.close()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# fault tolerance (repro_torch.faults): chaos, overflow retry, bf16 wire


def chaos_plan(np, faults, seed: int, blocks, *, kill_at=3):
    """The seeded plan of the chaos disk SSSP: a corrupt ``seg`` and a corrupt
    ``gat`` slice, two transient I/O errors on one block, a straggler, a
    broken prefetch thread and a kill before iteration ``kill_at``, on four
    distinct blocks drawn from ``blocks`` (each fault on a block of its
    own, so no fetch exceeds the retry budget)."""
    rng = np.random.default_rng(seed)
    b_seg, b_gat, b_io, b_slow = (int(k) for k in rng.choice(list(blocks), 4, replace=False))
    return faults.FaultPlan(events=(
        faults.CorruptFetch(block=b_seg, array="seg"),
        faults.CorruptFetch(block=b_gat, array="gat"),
        faults.TransientIO(block=b_io, times=2),
        faults.SlowFetch(block=b_slow, delay_s=0.05),
        faults.BreakPrefetch(),
        faults.KillAtIteration(iteration=kill_at)), seed=seed)


def nonempty_blocks(np, root, striping: str, by: str = "destination") -> list:
    """The blocks a disk leg walks (its schedule): the non-empty destination
    (or source) blocks of ``striping``."""
    from repro_torch.store import open_store
    from repro_torch.store import format as fmt

    nnz = np.asarray(open_store(root).array(fmt.nnz_array_of(striping)))
    rows = nnz if by == "destination" else nnz.T
    return [k for k in range(nnz.shape[0]) if rows[k].any()]


def chaos_disk(torch, np, sp, csgraph, dev, edges, n, root, budget, seed, clean, rows,
               failures):
    """The chaos disk SSSP and the disk overflow retry (module doc, phase 7):
    both on the store and budget of the disk solves, each bitwise the clean
    ``sssp/vertical disk`` answer ``clean`` = (v, iterations, median
    iteration s) and scipy's, kernel 3's launches counted."""
    import shutil
    import tempfile

    from repro_torch import faults, kernels
    from repro_torch.core import PMVEngine, sssp
    from repro_torch.obs import Recorder

    clean_v, clean_iters, clean_med = clean
    want = sssp_ref(np, sp, csgraph, edges, n, 0)
    kw = dict(store=root, residency="disk", strategy="vertical", scatter="kernel",
              backend="auto", store_budget_bytes=budget, device=dev)
    plan = chaos_plan(np, faults, seed, nonempty_blocks(np, root, "vertical"))
    rec = Recorder()
    eng = PMVEngine(None, faults=plan, obs=rec, **kw)
    spec = sssp(0)
    ex = eng.prepare(spec)[-1]["executor"]
    ck = tempfile.mkdtemp(prefix="pmv_ckpt_")
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t = time.perf_counter()
        try:
            eng.run(spec, max_iters=100, tol=0.5, checkpoint_dir=ck, checkpoint_every=1)
            killed = False
        except faults.InjectedKill:
            killed = True
        t_kill = time.perf_counter() - t
        t = time.perf_counter()
        res = eng.run(spec, max_iters=100, tol=0.5, checkpoint_dir=ck, checkpoint_every=1,
                      resume=True)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t
        counts = kernels.launch_counts()
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    got = {k: rec.counter(f"fault.injected.{k}").value for k in faults.FAULT_KINDS}
    verify_failures = rec.counter("store.verify_failures").value
    degraded = rec.counter("store.prefetch_degraded").value
    med = float(np.median([r["wall_s"] for r in res.per_iter]))
    log(f"chaos sssp/vertical disk: plan {[(e.kind, getattr(e, 'block', None)) for e in plan.events]} "
        f"seed={seed}; killed={killed} after {t_kill:.3f} s, resumed at iteration "
        f"{res.per_iter[0]['iteration']} to {res.iterations} iterations in {t_resume:.3f} s; "
        f"median_iter_s={med:.4f} (synchronous fetches) vs the clean run's {clean_med:.4f}; "
        f"injected={json.dumps(got)} plan.counts()={json.dumps(plan.counts())} "
        f"retry={rec.counter('fault.retry').value:.0f} "
        f"recovered={rec.counter('fault.recovered').value:.0f} "
        f"verify_failures={verify_failures:.0f} prefetch_degraded={degraded:.0f} "
        f"remaining={eng._fault_injector.remaining} "
        f"launches={json.dumps({k: v for k, v in counts.items() if v})}")
    corrupt = plan.counts()["corrupt_fetch"]
    ok = (killed and res.iterations == clean_iters and np.array_equal(res.v, clean_v)
          and np.array_equal(res.v.astype(np.float64), want)
          and eng._fault_injector.remaining == 0 and got == plan.counts()
          and verify_failures == corrupt and degraded == 1)
    log(f"check chaos sssp/vertical disk: killed, resumed bitwise the clean disk answer and "
        f"scipy's with equal iterations, every fault fired and counted, {corrupt} corrupt "
        f"slices caught, the prefetch degraded once -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("chaos sssp/vertical disk: the resumed answer or the fault counters "
                        "disagree")
    count_disk_launches("chaos sssp/vertical disk", "scatter_combine", counts, rows)
    ex.close()
    del eng, ex

    # -- the overflow retry: a model capacity far below the partials' ------
    rec = Recorder()
    eng = PMVEngine(None, capacity="model", slack=0.01, obs=rec, **kw)
    spec = sssp(0)
    meta = eng.prepare(spec)[-1]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    res = eng.run(spec, max_iters=100, tol=0.5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    fallbacks = rec.counter("pmv.fallbacks").value
    log(f"overflow sssp/vertical disk: capacity='model' slack=0.01 -> capacity "
        f"{meta['capacity']} (structural {meta['store'].manifest.partial_cap}); "
        f"fallback={res.totals.get('fallback')} pmv.fallbacks={fallbacks:.0f} "
        f"iterations={res.iterations} in {wall:.3f} s (the overflowing first iteration "
        f"and the structural retry) "
        f"launches={json.dumps({k: v for k, v in counts.items() if v})}")
    ok = (res.totals.get("fallback") == "structural_capacity" and fallbacks == 1
          and res.iterations == clean_iters and np.array_equal(res.v, clean_v))
    log(f"check overflow sssp/vertical disk: fallback structural_capacity once, bitwise the "
        f"clean disk answer -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("overflow sssp/vertical disk: no structural fallback or a different "
                        "answer")
    count_disk_launches("overflow sssp/vertical disk", "scatter_combine", counts, rows)
    meta["executor"].close()
    del eng, meta


def chaos_serve(torch, np, dev, root, theta, budget, seed, sssp_answers, rows, failures, *,
                q=4):
    """The chaos disk serve (module doc, phase 7): the first ``q`` SSSP sources
    of the resident serve through the hybrid disk server under one corrupt
    slice and one transient I/O error, at Q = ``q``: bitwise the resident
    answers, both faults recovered, kernel 6 launched."""
    from repro_torch import faults, kernels
    from repro_torch.obs import Recorder
    from repro_torch.serving import PMVServer, Query

    sparse = nonempty_blocks(np, root, "sparse_vertical")
    dense = nonempty_blocks(np, root, "dense_horizontal", by="source")
    # not the first block of either leg's schedule: the legs share the
    # injector's fetch counts, and each leg's first block is the one its
    # pipeline fetches while the other leg runs
    pick = sorted((set(sparse) | set(dense)) - {sparse[0], dense[0]})
    rng = np.random.default_rng(seed + 1)
    b_bad, b_io = (int(k) for k in rng.choice(pick, 2, replace=False))
    plan = faults.FaultPlan(events=(faults.CorruptFetch(block=b_bad, array="gat"),
                                    faults.TransientIO(block=b_io)), seed=seed)
    rec = Recorder()
    srv = PMVServer(store=root, residency="disk", strategy="hybrid", theta=theta,
                    backend="auto", scatter="kernel", store_budget_bytes=budget, device=dev,
                    faults=plan, obs=rec, buckets=(q,))
    answers = sssp_answers[:q]
    queries = [Query("sssp", source=int(s), tol=0.5) for s, _, _ in answers]
    eng, fspec = srv.engine_for(queries[0])
    eng.prepare(fspec)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    got = srv.serve(queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.launch_counts()
    st = srv.stats()
    inj = rec.counter("fault.injected").value
    recovered = rec.counter("fault.recovered").value
    log(f"chaos disk serve: {len(queries)} SSSP at Q = {q} (hybrid, theta={theta}) in "
        f"{wall:.3f} s, batches={st['batches']} batched iterations={st['iterations']:.0f}; "
        f"plan corrupt gat block {b_bad}, transient I/O block {b_io}: injected={inj:.0f} "
        f"retry={rec.counter('fault.retry').value:.0f} recovered={recovered:.0f} "
        f"verify_failures={rec.counter('store.verify_failures').value:.0f} "
        f"launches={json.dumps({k: v for k, v in counts.items() if v})}")
    ok = (all(r.reason == "completed" and r.iterations == it and np.array_equal(r.vector, v)
              for r, (_, v, it) in zip(got, answers))
          and inj == 2 and recovered == 2 and eng._fault_injector.remaining == 0)
    log(f"check chaos disk serve: answers and iteration counts bitwise the resident serve's, "
        f"both fetch faults recovered -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("chaos disk serve disagrees with the resident serve or lost a fault")
    count_disk_launches("chaos disk serve", "scatter_combine_multi", counts, rows)
    srv.close()


def bf16_phase(torch, np, sp, dev, edges, n, b, rows, failures, *, iters=20, every=5,
               bound=1e-2):
    """The resident bfloat16 wire with checkpoint / resume (module doc, phase
    4b): PageRank at tol 0 through ``payload_dtype='bfloat16'``, once
    uninterrupted and once checkpointed every ``every`` iterations, stopped
    at ``iters // 2`` and resumed on the same engine: the two answers
    bitwise equal, the max relative error against scipy's float64 power
    iteration within ``bound``, the payload bytes half the float32 wire's,
    kernels 1 and 3 launched; then the cost of one checkpoint save."""
    import os
    import shutil
    import tempfile

    from repro_torch import kernels
    from repro_torch.core import PMVEngine, pagerank, sparse_exchange
    from repro_torch.core.engine import _ckpt_path

    eng = PMVEngine(edges, n, b=b, strategy="vertical", backend="auto", scatter="kernel",
                    payload_dtype="bfloat16", device=dev)
    spec = pagerank(n)
    meta = eng.prepare(spec)[-1]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    full = eng.run(spec, max_iters=iters, tol=0.0)
    ck = tempfile.mkdtemp(prefix="pmv_ckpt_")
    try:
        half = eng.run(spec, max_iters=iters // 2, tol=0.0, checkpoint_dir=ck,
                       checkpoint_every=every)
        resumed = eng.run(spec, max_iters=iters, tol=0.0, checkpoint_dir=ck,
                          checkpoint_every=every, resume=True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        # one save's legs, as _ckpt_save makes them: the blocked v to the
        # host, np.savez into a temp file, os.replace over the live file
        v_dev = torch.from_numpy(meta["part"].to_blocked(full.v)).to(dev)
        legs = {"d2h": [], "savez": [], "replace": []}
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v_host = v_dev.cpu().numpy()
            t1 = time.perf_counter()
            tmp = os.path.join(ck, "pmv_state.tmp.npz")
            np.savez(tmp, v=v_host, it=iters)
            t2 = time.perf_counter()
            os.replace(tmp, _ckpt_path(ck))
            t3 = time.perf_counter()
            for k, dt in zip(legs, (t1 - t0, t2 - t1, t3 - t2)):
                legs[k].append(dt)
        ckpt_bytes = os.path.getsize(_ckpt_path(ck))
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    med_iter = float(np.median([r["wall_s"] for r in full.per_iter]))
    save = {k: float(np.median(x)) for k, x in legs.items()}
    want = pagerank_ref(np, sp, edges, n, iters)
    rel = float(np.max(np.abs(full.v - want) / np.maximum(np.abs(want), 1e-30)))
    l1 = float(np.abs(full.v - want).sum())
    cap = meta["capacity"]
    _, pay16 = sparse_exchange.exchange_wire_split(b, cap, None, 2)
    _, pay32 = sparse_exchange.exchange_wire_split(b, cap, None, 4)
    pays = {r["exchange_payload_bytes"] for r in full.per_iter}
    log(f"run pagerank/vertical bf16: payload_dtype=bfloat16 exchange={meta['exchange']} "
        f"capacity={cap} stream={meta['plan'].stream} prepare_s={meta['prepare_s']:.2f} "
        f"iterations={full.iterations} median_iter_ms={1e3 * med_iter:.3f}; resumed from "
        f"iteration {resumed.per_iter[0]['iteration']} ({half.iterations} run, checkpoint "
        f"every {every}); exchange_payload_bytes per iteration {sorted(pays)} (float32 wire "
        f"{pay32:.0f}); max rel err vs scipy float64 {rel:.3e} (bound {bound:g}), L1 {l1:.3e}; "
        f"launches={json.dumps({k: v for k, v in counts.items() if v})}")
    log(f"checkpoint save ({ckpt_bytes} B file of the blocked [{b}, {meta['part'].n_local}] "
        f"float32 v): d2h {1e3 * save['d2h']:.3f} ms, np.savez {1e3 * save['savez']:.3f} ms, "
        f"os.replace {1e3 * save['replace']:.3f} ms, total "
        f"{1e3 * sum(save.values()):.3f} ms = {sum(save.values()) / med_iter:.4g}x the "
        f"median iteration ({1e3 * med_iter:.3f} ms; medians of 5 saves)")
    ok = (np.array_equal(resumed.v, full.v) and resumed.iterations == full.iterations == iters
          and half.iterations == iters // 2 and rel <= bound and pays == {pay16}
          and 2 * pay16 == pay32)
    log(f"check pagerank/vertical bf16: resumed bitwise the uninterrupted run, within "
        f"{bound:g} of scipy, payload bytes half the float32 wire's -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("pagerank/vertical bf16: resume not bitwise, error over its bound or "
                        "payload bytes not halved")
    for name in ("ell_gimv", "scatter_combine"):
        if counts[name] == 0:
            raise SmokeError(f"pagerank/vertical bf16: kernel {name} never launched")
        rows[name]["launches"] += counts[name]
        rows[name]["bf16_launches"] = rows[name].get("bf16_launches", 0) + counts[name]
    del eng, meta, v_dev
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# stream phase

STREAM_B = 64


def expected_stream_launches(plan) -> int:
    """ELL launches of one bucket-streamed step, from the plan alone: per
    destination block, the degree buckets that hold a row of the block on
    some worker (``ExecutionPlan.launch_schedule``).  A bucket that the
    stacking drops (empty on every worker and block) holds no such row."""
    scheds = [plan.launch_schedule(j) for j in range(plan.b)]
    total = 0
    for i in range(plan.b):
        used = set()
        for sched in scheds:
            if sched[i][0] == "ell":
                used.update(k for k, r in enumerate(sched[i][1]) if r)
        total += len(used)
    return total


def memory_profile_line(plan) -> str:
    from repro_torch.core.planner import format_plan

    return next(line.strip() for line in format_plan(plan).splitlines()
                if "memory profile" in line)


def stream_solve(torch, np, label, eng, spec, *, want_stream, max_iters, tol):
    """One counted solve of the stream phase: prepare, require the plan's
    schedule to be ``want_stream``, then run with the launch counters zeroed
    and the peak reset just before.  The peak is read above the bytes
    allocated after prepare (the resident matrix and state).  Returns (res,
    matrix, meta, counts, peak step bytes above resident, resident bytes)."""
    from repro_torch import kernels

    matrix, _, _, _, meta = eng.prepare(spec)
    if meta["plan"].stream != want_stream:
        raise SmokeError(f"{label}: the plan resolved stream={meta['plan'].stream!r}, "
                         f"not {want_stream!r}")
    if meta["backend"] != "planned":
        raise SmokeError(f"{label}: backend resolved to {meta['backend']!r}")
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = eng.run(spec, max_iters=max_iters, tol=tol)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() - resident
    walls = [1e3 * r["wall_s"] for r in res.per_iter]
    log(f"run {label}: stream={meta['plan'].stream} iterations={res.iterations} "
        f"converged={res.converged} prepare_s={meta['prepare_s']:.2f} "
        f"first_iter_ms={walls[0]:.3f} median_later_iter_ms={np.median(walls[1:] or walls):.3f} "
        f"resident_bytes={resident} peak_step_bytes_above_resident={peak} "
        f"launches={json.dumps(counts)}")
    return res, matrix, meta, counts, peak, resident


def count_stream_launches(label: str, expect, counts: dict, rows: dict) -> None:
    for name in expect:
        if counts[name] == 0:
            raise SmokeError(f"{label}: kernel {name} never launched on the streamed path")
    for name, c in counts.items():
        if c:
            row = rows.setdefault(name, {"launches": 0})
            row["launches"] += c
            row["stream_launches"] = row.get("stream_launches", 0) + c


def stream_ell_holds(torch, label, fs, v_flat, semiring, rand_v, rows) -> None:
    """Kernel 1 (v [N]) or 5 (v [N, Q]) on every (destination block, active
    bucket) view the streamed executor launches, against its plain version
    with the run's semiring on the run's state; on every 16th block also for
    4 semirings + int32 min_src on random vectors; plus_times the same bits
    twice.  The largest error goes into the row's ``stream_checks``."""
    from repro_torch.kernels import ell_spmv

    multi = v_flat.ndim == 2
    name = "ell_gimv_multi" if multi else "ell_gimv"
    fn = ell_spmv.ell_gimv_multi if multi else ell_spmv.ell_gimv
    ref = ell_spmv.ell_gimv_multi_ref if multi else ell_spmv.ell_gimv_ref
    sweep = [(sr, dt, rand_v(dt)) for sr, dt in (
        ("plus_times", torch.float32), ("min_plus", torch.float32),
        ("max_plus", torch.float32), ("min_src", torch.float32), ("min_src", torch.int32))]
    err, views = 0.0, 0
    for k, act in enumerate(fs.active):
        for i in act:
            bk = fs.buckets[i]
            cols, w = bk.cols[k], None if bk.w is None else bk.w[k]
            what = f"{label} block {k} bucket {i} {tuple(cols.shape)}"
            got = fn(cols, w, v_flat, semiring=semiring)
            err = max(err, compare(torch, got, ref(cols, w, v_flat, semiring=semiring),
                                   semiring, f"{what} {semiring} run state"))
            if semiring == "plus_times" and not torch.equal(
                    got, fn(cols, w, v_flat, semiring=semiring)):
                raise SmokeError(f"{what}: plus_times not the same bits twice")
            views += 1
            if k % 16:
                continue
            for sr, dt, v in sweep:
                got = fn(cols, w, v, semiring=sr)
                compare(torch, got, ref(cols, w, v, semiring=sr), sr, f"{what} {sr} {dt}")
                if sr == "plus_times" and not torch.equal(got, fn(cols, w, v, semiring=sr)):
                    raise SmokeError(f"{what}: plus_times not the same bits twice")
    rows.setdefault(name, {"launches": 0}).setdefault("stream_checks", []).append(
        {"path": label, "semiring": semiring, "views": views, "max_abs_err": err})
    log(f"kernels {label}: {name} matches its plain version on all {views} (block, bucket) "
        f"views ({semiring}, run state; max |err| {err}) and, on every 16th block, for 4 "
        "semirings and int32; plus_times the same bits twice")


def stream_scatter_holds(torch, label, idx, val, nl, semiring, rand_val, rows) -> None:
    """Kernel 3 (val [S, B, cap]) or 6 (val [S, B, cap, Q]) on the compacted
    buffers the streamed executor built, after the exchange transpose:
    against its plain version with the run's semiring on the run's values and
    with the other selection semiring or plus_times on random values,
    bitwise the sender-order fold each time; plus_times the same bits twice."""
    from repro_torch.kernels import scatter_combine

    multi = val.ndim == idx.ndim + 1
    name = "scatter_combine_multi" if multi else "scatter_combine"
    sc = scatter_combine
    fn, ref = ((sc.scatter_combine_gimv_multi, sc.scatter_combine_multi_ref) if multi else
               (sc.scatter_combine_gimv, sc.scatter_combine_ref))
    rows_x = sparse_rows(torch, idx, nl)
    other = "plus_times" if semiring != "plus_times" else "min_plus"
    err = 0.0
    for sr, vv in ((semiring, val), (other, rand_val())):
        got = fn(idx, vv, nl, semiring=sr)
        what = f"{label}: {name} {sr} on {tuple(vv.shape)}"
        e = compare(torch, got, ref(idx, vv, nl, semiring=sr), sr, what)
        err = e if sr == semiring else err
        check_sender_order(torch, got, rows_x, vv if multi else vv[..., None],
                           idx.shape[0] * nl, sr, what)
        if sr == "plus_times" and not torch.equal(got, fn(idx, vv, nl, semiring=sr)):
            raise SmokeError(f"{what}: plus_times not the same bits twice")
        del got, vv
    rows.setdefault(name, {"launches": 0}).setdefault("stream_checks", []).append(
        {"path": label, "shape": list(val.shape), "semiring": semiring, "max_abs_err": err})
    log(f"kernels {label}: {name} matches its plain version on the streamed buffers "
        f"{list(val.shape)} n_local {nl} ({semiring} max |err| {err}; {other} on random "
        "values), bitwise the sender-order fold; plus_times the same bits twice")


def stream_phase(torch, np, sp, csgraph, dev, gen, scale, seed, rows, failures, peaks, *,
                 b=STREAM_B):
    """Phase 8 (see the module doc): the bucket-streamed planned executor on
    ``erdos_renyi(2**scale, 16 * 2**scale)`` at b workers (64), cyclic ψ."""
    from repro_torch.core import PMVEngine, placement, sssp
    from repro_torch.graph import erdos_renyi

    t_phase = time.perf_counter()
    n = 1 << scale
    t = time.perf_counter()
    edges = erdos_renyi(n, 16 * n, seed=seed)
    log(f"stream graph: erdos_renyi n={n} edges={len(edges)} b={b} "
        f"({time.perf_counter() - t:.1f} s)")
    kw = dict(b=b, strategy="vertical", backend="auto", scatter="kernel", device=dev)
    spec = sssp(0)

    # -- run 1: SSSP with the default stream='auto' ---------------------------
    eng = PMVEngine(edges, n, **kw)
    res, matrix, meta, counts, peak_on, resident_on = stream_solve(
        torch, np, "sssp/vertical streamed", eng, spec, want_stream="on", max_iters=100, tol=0.5)
    plan, fs = meta["plan"], matrix["streamed"]
    mp = plan.memory_profile()
    log(f"stream plan: capacity={plan.capacity} n_local={plan.n_local} "
        f"tactics={json.dumps(plan.tactic_counts())} buckets={plan.boundaries}; "
        f"{memory_profile_line(plan)}")
    per_step = expected_stream_launches(plan)
    log(f"stream launches: {per_step} ELL launches a step from the launch schedule "
        f"(the layout's {fs.launches_per_step()}), {res.iterations} iterations")
    if fs.launches_per_step() != per_step:
        raise SmokeError(f"stream: the layout launches {fs.launches_per_step()} ELL kernels a "
                         f"step, the launch schedule {per_step}")
    count_stream_launches("sssp/vertical streamed", ("ell_gimv", "scatter_combine"), counts, rows)
    if counts["ell_gimv"] != per_step * res.iterations or \
            counts["scatter_combine"] != res.iterations:
        raise SmokeError(f"sssp/vertical streamed: {counts['ell_gimv']} ELL and "
                         f"{counts['scatter_combine']} scatter launches over {res.iterations} "
                         f"iterations, expected {per_step} and 1 an iteration")
    want = sssp_ref(np, sp, csgraph, edges, n, 0)
    ok = res.converged and np.array_equal(res.v.astype(np.float64), want)
    log(f"check streamed sssp vs scipy shortest_path: reached {int(np.isfinite(want).sum())} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("streamed sssp disagrees with scipy")
    prof = device_breakdown(torch, lambda: eng.run(spec, max_iters=3, tol=-1.0), 3)
    log(f"profile sssp/vertical streamed: {json.dumps(prof)}")

    # -- kernels 1 and 3 on the streamed run's own per-block buffers ----------------
    part, nl = meta["part"], plan.n_local
    v_local = torch.from_numpy(part.to_blocked(res.v.astype(np.float32)).copy()).to(dev)
    v_prev = torch.where(torch.rand(v_local.shape, generator=gen, device=dev) < 0.5,
                         v_local, torch.full_like(v_local, float("inf")))
    n_src = v_prev.numel()

    def rand_v(dt):
        if dt == torch.int32:
            return torch.randint(0, n, (n_src,), generator=gen, device=dev, dtype=torch.int32)
        return torch.rand(n_src, generator=gen, device=dev)

    stream_ell_holds(torch, "sssp streamed", fs, v_prev.reshape(-1), "min_plus", rand_v, rows)
    idx, val, _, _ = placement._streamed_planned_compact(spec, fs, v_prev, plan.capacity)
    idx, val = idx.transpose(0, 1).contiguous(), val.transpose(0, 1).contiguous()
    stream_scatter_holds(torch, "sssp streamed", idx, val, nl, "min_plus",
                         lambda: torch.rand(val.shape, generator=gen, device=dev), rows)
    del eng, matrix, fs, idx, val, v_local, v_prev
    torch.cuda.empty_cache()

    # -- run 2: the same solve with stream='off' (the fused schedule) ----------------
    eng = PMVEngine(edges, n, stream="off", **kw)
    off, _, _, counts, peak_off, resident_off = stream_solve(
        torch, np, "sssp/vertical fused", eng, spec, want_stream="off", max_iters=100, tol=0.5)
    count_stream_launches("sssp/vertical fused", ("ell_gimv", "scatter_combine"), counts, rows)
    ok = np.array_equal(off.v, res.v) and off.iterations == res.iterations
    log(f"check streamed sssp bitwise the fused solve: -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("streamed sssp is not bitwise the stream='off' solve")
    ratio = peak_off / max(peak_on, 1)
    log(f"stream memory: peak step bytes above resident: streamed {peak_on} "
        f"({peak_on / 2**30:.3f} GiB), fused {peak_off} ({peak_off / 2**30:.3f} GiB); "
        f"measured ratio {ratio:.2f}x beside memory_profile() {mp['savings']:.2f}x; "
        f"resident bytes streamed {resident_on}, fused {resident_off}")
    peaks["sssp/vertical streamed"] = peak_on / 2**30
    if not peak_on < peak_off:
        failures.append(f"stream: the streamed peak {peak_on} B is not below the fused "
                        f"{peak_off} B")
    del eng
    torch.cuda.empty_cache()

    # -- run 3: 64 RWR queries served in one Q = 64 batch, streamed ----------------
    stream_serve(torch, np, sp, dev, gen, edges, n, b, seed, rows, failures, peaks)
    log(f"stream phase: {time.perf_counter() - t_phase:.1f} s")


def stream_serve(torch, np, sp, dev, gen, edges, n, b, seed, rows, failures, peaks) -> None:
    """``PMVServer(strategy='vertical', backend='auto', scatter='kernel')`` on
    the stream phase's graph: 64 RWR queries (c 0.85, tol 1e-6) in one
    Q = 64 batch through the streamed Q-wide executor; then kernels 5 and 6
    on the batch's own per-block buffers."""
    from repro_torch import kernels
    from repro_torch.core import placement
    from repro_torch.serving import PMVServer, Query

    outdeg = np.bincount(edges[:, 0], minlength=n)
    srcs = np.random.default_rng(seed + 1).choice(np.flatnonzero(outdeg >= 1), 64, replace=False)
    queries = [Query("rwr", source=int(s), c=0.85, tol=1e-6) for s in srcs]
    srv = PMVServer(edges, n, b=b, strategy="vertical", backend="auto", scatter="kernel",
                    device=dev, max_iters=200)
    t = time.perf_counter()
    eng, fspec = srv.engine_for(queries[0])
    matrix, _, _, _, fmeta = eng.prepare(fspec)
    plan = fmeta["plan"]
    log(f"stream serve family rwr: prepare_s={fmeta['prepare_s']:.2f} (wall "
        f"{time.perf_counter() - t:.1f} s) stream={plan.stream} capacity={plan.capacity}; "
        f"{memory_profile_line(plan)}")
    if plan.stream != "on" or "streamed" not in matrix:
        raise SmokeError(f"stream serve: the family's plan resolved stream={plan.stream!r}")
    fs = matrix["streamed"]
    per_step = expected_stream_launches(plan)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    results = srv.serve(queries)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    peaks["stream serve"] = peak / 2**30
    st = srv.stats()
    walls = [1e3 * w for w in st["iter_wall_s"]]
    iters = [r.iterations for r in results]
    log(f"stream serve: {len(results)} queries in {serve_s:.3f} s -> "
        f"{len(results) / serve_s:.3f} queries/s; batches={st['batches']} batched "
        f"iterations={int(st['iterations'])} median_iter_ms={np.median(walls):.3f} "
        f"max_iter_ms={max(walls):.3f} peak_gib={peak / 2**30:.3f} (above resident "
        f"{(peak - resident) / 2**30:.3f}) query iterations {min(iters)}-{max(iters)} "
        f"reasons={json.dumps(st['retirement_reasons'])} launches={json.dumps(counts)}")
    bad = [r.qid for r in results if r.reason != "completed" or not r.converged]
    if bad:
        failures.append(f"stream serve: {len(bad)} queries did not retire completed and "
                        f"converged (qids {bad[:10]})")
    if st["batches"] != 1:
        failures.append(f"stream serve: {st['batches']} batches, expected one Q = 64 batch")
    count_stream_launches("stream serve", ("ell_gimv_multi", "scatter_combine_multi"), counts,
                          rows)
    for name in SINGLE:
        if counts[name] != 0:
            raise SmokeError(f"stream serve: single-vector kernel {name} launched "
                             f"{counts[name]} times while serving")
    if counts["ell_gimv_multi"] != per_step * int(st["iterations"]):
        raise SmokeError(f"stream serve: {counts['ell_gimv_multi']} ELL launches over "
                         f"{int(st['iterations'])} batched iterations, expected {per_step} "
                         "an iteration")
    pick = results[::8][:8]
    want = rwr_ref(np, sp, edges, n, [r.query.source for r in pick], [r.iterations for r in pick])
    got = np.stack([r.vector for r in pick], axis=1)
    ok = np.allclose(got, want, rtol=1e-4, atol=1e-12)
    rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
    log(f"check stream serve rwr x{len(pick)} vs scipy power iteration (their own iteration "
        f"counts): max rel err {rel:.3e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("streamed served rwr disagrees with scipy")

    # -- kernels 5 and 6 on the batch's own per-block buffers ------------------------
    part, nl = fmeta["part"], plan.n_local
    state = np.stack([part.to_blocked(r.vector) for r in results], axis=-1)
    v_state = torch.from_numpy(np.ascontiguousarray(state)).to(dev)        # [b, nl, 64]
    del state

    def rand_v(dt):
        if dt == torch.int32:
            return torch.randint(0, n, (n, 64), generator=gen, device=dev, dtype=torch.int32)
        return torch.rand((n, 64), generator=gen, device=dev)

    stream_ell_holds(torch, "stream serve", fs, v_state.reshape(-1, 64), "plus_times", rand_v,
                     rows)
    idx, val, _, _ = placement._streamed_planned_compact(fspec, fs, v_state, plan.capacity)
    idx, val = idx.transpose(0, 1).contiguous(), val.transpose(0, 1).contiguous()
    stream_scatter_holds(torch, "stream serve", idx, val, nl, "plus_times",
                         lambda: torch.rand(val.shape, generator=gen, device=dev), rows)
    srv.close()
    del srv, eng, matrix, fs, idx, val, v_state
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
# spmd phase: one rank per worker through torch.distributed
# ---------------------------------------------------------------------------

SPMD_RANK_TIMEOUT_S = 300.0


def spmd_nccl(torch, np, sp, csgraph, dev, seed, rows, failures, *, scale=16) -> None:
    """Part (a) of the spmd phase: one NCCL rank in this process
    (``init_process_group('nccl', world_size=1)`` on a file store), an SSSP
    from 0 over a mesh of size 1 at b = 1 on RMAT(``scale``): it must equal
    scipy and, bitwise, the emulated b = 1 engine.  One rank moves no bytes:
    it shows that NCCL takes the port's tensors, not a transfer."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import kernels
    from repro_torch.core import PMVEngine, sssp
    from repro_torch.graph import rmat

    n = 1 << scale
    edges = rmat(scale, 16 << scale, seed=seed)
    kw = dict(b=1, strategy="vertical", backend="auto", scatter="kernel", stream="off",
              device=dev)
    d = tempfile.mkdtemp(prefix="pmv_nccl_")
    t = time.perf_counter()
    try:
        dist.init_process_group("nccl", init_method=f"file://{d}/store", rank=0, world_size=1,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("workers",))
            eng = PMVEngine(edges, n, mesh=mesh, **kw)
            eng.prepare(sssp(0))
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            res = eng.run(sssp(0), max_iters=100, tol=0.5)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    emul = PMVEngine(edges, n, **kw).run(sssp(0), max_iters=100, tol=0.5)
    want = sssp_ref(np, sp, csgraph, edges, n, 0)
    ok_ref = res.converged and np.array_equal(res.v.astype(np.float64), want)
    ok_emul = np.array_equal(res.v, emul.v) and res.iterations == emul.iterations
    walls = [1e3 * r["wall_s"] for r in res.per_iter]
    log(f"spmd nccl W=1: sssp/vertical b=1 rmat scale {scale} over NCCL (one rank: every "
        f"collective is local, no byte crosses a process): iterations={res.iterations} "
        f"median_iter_ms={np.median(walls):.3f} launches={json.dumps(counts)} "
        f"scipy {'ok' if ok_ref else 'FAIL'}, bitwise the emulated b=1 engine "
        f"{'ok' if ok_emul else 'FAIL'} ({time.perf_counter() - t:.1f} s)")
    if not (ok_ref and ok_emul):
        failures.append("spmd nccl W=1 sssp disagrees with scipy or the emulated engine")
    for name in ("ell_gimv", "scatter_combine"):
        if counts[name] == 0:
            raise SmokeError(f"spmd nccl: kernel {name} never launched")
        rows.setdefault(name, {"launches": 0})["launches"] += counts[name]


def spmd_rank(rank: int, d: str) -> int:
    """One rank of the spmd phase's gloo part (``chip_smoke.py --spmd-rank R
    --spmd-dir D``): the runs of ``D/payload.json`` on the shared graph
    ``D/edges.npy`` (the hier SSSP and the serve on ``D/edges_small.npy``),
    each between barriers with the launch counters zeroed
    before it and read after it; results in ``D/r{R}.json`` (and rank 0's
    vectors in ``D/*.npy``).  Leaves with ``os._exit`` after a last barrier,
    so no rank tears its gloo group down while a peer still talks to it."""
    import os
    import traceback

    code = 1
    try:
        with open(os.path.join(d, "payload.json")) as f:
            cfg = json.load(f)
        sys.path.insert(0, cfg["src"])
        import numpy as np
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch import kernels
        from repro_torch.core import PMVEngine, collectives, pagerank, sssp
        from repro_torch.serving import PMVServer, Query

        torch.set_num_threads(1)
        world, n, n_small = cfg["world"], cfg["n"], cfg["n_small"]
        dev = collectives.rank_device(cfg["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        t0 = time.perf_counter()
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                                world_size=world)
        flat = DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=("workers",))
        pods = DeviceMesh(dev.type, torch.arange(world).reshape(2, world // 2),
                          mesh_dim_names=("pod", "workers"))
        edges = np.load(os.path.join(d, "edges.npy"))
        small = np.load(os.path.join(d, "edges_small.npy"))
        out = {"rank": rank, "device": str(dev), "up_s": time.perf_counter() - t0}

        def counted(label, fn):
            dist.barrier()
            kernels.reset_launch_counts()
            t = time.perf_counter()
            res = fn()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[label] = {"s": time.perf_counter() - t, "launches": kernels.launch_counts()}
            return res

        def solve(label, spec, max_iters, tol, graph=(edges, n), **kw):
            eng = PMVEngine(*graph, b=world, backend="auto", device=dev, **kw)
            res = counted(label, lambda: eng.run(spec, max_iters=max_iters, tol=tol))
            meta = eng.prepare(spec)[-1]
            out[label].update(
                iterations=res.iterations, converged=res.converged,
                prepare_s=meta["prepare_s"], exchange=meta["exchange"],
                walls_ms=[1e3 * r["wall_s"] for r in res.per_iter],
                stats={k: [r.get(k, 0.0) for r in res.per_iter]
                       for k in ("exchanged_elems", "inter_pod_elems", "intra_pod_elems",
                                 "logical_elems")})
            if rank == 0:
                np.save(os.path.join(d, f"{label}.npy"), res.v)
            del eng
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        solve("sssp_flat", sssp(0), 100, 0.5, strategy="vertical", scatter="kernel",
              stream="off", mesh=flat)
        solve("pagerank_horizontal", pagerank(n), 100, 1e-6, strategy="horizontal", mesh=flat)
        solve("sssp_hier", sssp(0), 100, 0.5, graph=(small, n_small), strategy="vertical",
              scatter="kernel", stream="off", exchange="hier", mesh=pods,
              axis_name=("pod", "workers"))
        srv = PMVServer(small, n_small, b=world, strategy="hybrid", theta=cfg["theta"],
                        backend="auto", scatter="kernel", mesh=flat, device=dev)
        try:
            queries = [Query("rwr", source=int(s), tol=1e-6) for s in cfg["rwr_sources"]]
            got = counted("serve_rwr", lambda: srv.serve(queries))
            st = srv.stats()
            fam, fspec = srv.engine_for(queries[0])
            out["serve_rwr"]["prepare_s"] = fam.prepare(fspec)[-1]["prepare_s"]
        finally:
            srv.close()
        out["serve_rwr"].update(
            iterations=[r.iterations for r in got], reasons=[r.reason for r in got],
            converged=[r.converged for r in got],
            iter_walls_ms=[1e3 * w for w in st["iter_wall_s"]])
        if rank == 0:
            np.save(os.path.join(d, "serve_rwr.npy"), np.stack([r.vector for r in got]))
        with open(os.path.join(d, f"r{rank}.tmp"), "w") as f:
            json.dump(out, f)
        os.replace(os.path.join(d, f"r{rank}.tmp"), os.path.join(d, f"r{rank}.json"))
        dist.barrier()
        code = 0
    except BaseException:  # noqa: BLE001 -- reported through the rank's log and exit code
        traceback.print_exc()
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)


def spmd_gloo(torch, np, sp, csgraph, dev, edges, n, b, theta, run2, rwr_sources, rows,
              failures, *, small=None, hints=None, expect_launches=True) -> None:
    """Part (b) of the spmd phase: ``b`` gloo ranks sharing ``dev``, each a
    subprocess that runs the kernels on the card (``spmd_rank``): the flat
    SSSP bitwise run 2 (``run2``: its answer and per-iteration exchanged
    elements) and a horizontal PageRank within rtol 1e-4 of scipy on
    ``edges``; on ``small`` ((edges, n), default the same graph) the
    two-hop SSSP on a (2, b/2) ('pod', 'workers') mesh equal to scipy with
    its inter-pod elements at the closed form and below the flat sparse
    exchange's at the same capacity, and a ``PMVServer(mesh=...)`` batch of
    8 RWR queries (``rwr_sources`` mod its n) within rtol 1e-4 of scipy.  The walls it prints cross gloo through host memory: no speed of
    the SPMD path (NCCL, NVLink) can be read from them.  While the ranks
    run, the scipy references are computed for the iteration counts in
    ``hints`` ({'pagerank': k, 'rwr': [k, ...]}, the emulated runs'), and
    again after for any count the ranks did not share."""
    import os
    import shutil
    import tempfile

    small_edges, n_small = small if small is not None else (edges, n)
    rwr_sources = [int(s) % n_small for s in rwr_sources]
    d = tempfile.mkdtemp(prefix="pmv_spmd_")
    procs = []
    t = time.perf_counter()
    try:
        np.save(os.path.join(d, "edges.npy"), edges)
        np.save(os.path.join(d, "edges_small.npy"), small_edges)
        with open(os.path.join(d, "payload.json"), "w") as f:
            json.dump({"src": str(Path(__file__).resolve().parent / "src"), "world": b, "n": n,
                       "n_small": n_small, "theta": theta, "device": str(dev),
                       "rwr_sources": rwr_sources}, f)
        for rank in range(b):
            log_f = open(os.path.join(d, f"r{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--spmd-rank", str(rank),
                 "--spmd-dir", d], stdout=log_f, stderr=subprocess.STDOUT,
                env={**os.environ, "LOCAL_RANK": str(rank), "OMP_NUM_THREADS": "1"}), log_f))
        deadline = time.monotonic() + SPMD_RANK_TIMEOUT_S
        hints = hints or {}
        pre = {}                            # the references, while the ranks run
        if "pagerank" in hints:
            pre["pagerank"] = (hints["pagerank"],
                               pagerank_ref(np, sp, edges, n, hints["pagerank"]))
        if "rwr" in hints:
            pre["rwr"] = (list(hints["rwr"]), rwr_ref(np, sp, small_edges, n_small, rwr_sources,
                                                      list(hints["rwr"])).T)
        hier_want = sssp_ref(np, sp, csgraph, small_edges, n_small, 0)
        for proc, _ in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        bad = [r for r, (p, _) in enumerate(procs) if p.poll() != 0]
        if bad:
            tails = []
            for r in bad[:3]:
                text = Path(d, f"r{r}.log").read_text(errors="replace")
                tails.append(f"--- rank {r} (exit {procs[r][0].poll()}) ---\n{text[-2500:]}")
            raise SmokeError("spmd gloo ranks failed:\n" + "\n".join(tails))
        res = [json.loads(Path(d, f"r{r}.json").read_text()) for r in range(b)]
        vec = {k: np.load(os.path.join(d, f"{k}.npy"))
               for k in ("sssp_flat", "pagerank_horizontal", "sssp_hier", "serve_rwr")}
    finally:
        for proc, log_f in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()
        shutil.rmtree(d, ignore_errors=True)
    wall = time.perf_counter() - t
    up = [r["up_s"] for r in res]
    where = (" (gloo stages the card's tensors through host memory; the kernels run on the "
             "card)" if dev.type == "cuda" else "")
    log(f"spmd gloo W={b}: {b} ranks on {res[0]['device']}{where}, group up in "
        f"{min(up):.1f}-{max(up):.1f} s")

    def line(label, what, ok, extra=""):
        r0 = res[0][label]
        med = [float(np.median(r[label].get("walls_ms") or r[label].get("iter_walls_ms")))
               for r in res]
        launches = {k: sum(r[label]["launches"][k] for r in res) for k in r0["launches"]}
        prep = [r[label].get("prepare_s", 0.0) for r in res]
        log(f"spmd run {label} W={b}: {what}; seconds {r0['s']:.1f}, prepare_s per rank "
            f"{min(prep):.2f}-{max(prep):.2f}, median iteration ms per rank "
            f"[{', '.join(f'{m:.2f}' for m in med)}], launches (all ranks)={json.dumps(launches)}"
            f"{extra} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"spmd {label} failed its check")
        return launches

    same = all(r["sssp_flat"]["stats"] == res[0]["sssp_flat"]["stats"] for r in res)
    flat = res[0]["sssp_flat"]
    ok = (flat["converged"] and np.array_equal(vec["sssp_flat"], run2["v"])
          and flat["stats"]["exchanged_elems"] == run2["exchanged_elems"] and same)
    counts = {"sssp_flat": line("sssp_flat", f"iterations={flat['iterations']}, bitwise run 2 "
                                f"and its exchanged_elems {run2['exchanged_elems'][-1]:.0f}", ok)}
    pr = res[0]["pagerank_horizontal"]
    its, want = pre.get("pagerank", (None, None))
    if its != pr["iterations"]:
        want = pagerank_ref(np, sp, edges, n, pr["iterations"])
    rel = float(np.max(np.abs(vec["pagerank_horizontal"] - want) / np.maximum(want, 1e-30)))
    ok = np.allclose(vec["pagerank_horizontal"], want, rtol=1e-4, atol=1e-12)
    counts["pagerank_horizontal"] = line(
        "pagerank_horizontal", f"iterations={pr['iterations']}, scipy max rel err {rel:.3e}", ok)
    hier = res[0]["sssp_hier"]
    w_in = b // 2
    closed = 2.0 * (2 - 1) * w_in * -(-n_small // b)
    inter, intra = hier["stats"]["inter_pod_elems"][-1], hier["stats"]["intra_pod_elems"][-1]
    # the flat sparse exchange at the same capacity: b(b-1) rows of cap
    # (idx, val) slots, where intra = P^2 W(W-1) cap 2
    flat_same = b * (b - 1) * intra / (2 ** 2 * w_in * (w_in - 1))
    ok = (hier["converged"] and hier["exchange"] == "hier"
          and np.array_equal(vec["sssp_hier"].astype(np.float64), hier_want)
          and all(x == closed for x in hier["stats"]["inter_pod_elems"])
          and inter < flat_same)
    counts["sssp_hier"] = line(
        "sssp_hier", f"rmat n={n_small}, (2, {w_in}) mesh, iterations={hier['iterations']}, "
        f"scipy; inter_pod_elems {inter:.0f} (closed form {closed:.0f}) < the flat sparse "
        f"exchange's {flat_same:.0f} at the same capacity; intra_pod_elems {intra:.0f}", ok)
    sv = res[0]["serve_rwr"]
    its, want = pre.get("rwr", (None, None))
    if its != sv["iterations"]:
        want = rwr_ref(np, sp, small_edges, n_small, rwr_sources, sv["iterations"]).T
    rel = float(np.max(np.abs(vec["serve_rwr"] - want) / np.maximum(np.abs(want), 1e-30)
                       * (np.abs(want) > 1e-12)))
    ok = (all(r == "completed" for r in sv["reasons"]) and all(sv["converged"])
          and np.allclose(vec["serve_rwr"], want, rtol=1e-4, atol=1e-12))
    counts["serve_rwr"] = line(
        "serve_rwr", f"rmat n={n_small}, PMVServer(mesh=) hybrid theta={theta}, "
        f"{len(rwr_sources)} RWR at Q = "
        f"{len(rwr_sources)}, iterations {min(sv['iterations'])}-{max(sv['iterations'])}, "
        f"scipy max rel err {rel:.3e}", ok)
    expect = {"sssp_flat": ("ell_gimv", "scatter_combine"), "pagerank_horizontal": ("ell_gimv",),
              "sssp_hier": ("ell_gimv", "scatter_combine"),
              "serve_rwr": ("ell_gimv_multi", "dense_gimv_multi", "scatter_combine_multi")}
    if expect_launches:
        for label, names in expect.items():
            for name in names:
                if counts[label][name] == 0:
                    raise SmokeError(f"spmd {label}: kernel {name} never launched on the path")
    for label in expect:
        for name, c in counts[label].items():
            if c:
                rows.setdefault(name, {"launches": 0})["launches"] += c
    log(f"spmd gloo phase: {wall:.1f} s for {b} ranks and 4 runs, the checks "
        f"{time.perf_counter() - t - wall:.1f} s after")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=20, help="RMAT scale: n = 2**scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v report")
    ap.add_argument("--spmd-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--spmd-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.spmd_rank is not None:          # one rank of the spmd phase (spmd_gloo)
        return spmd_rank(args.spmd_rank, args.spmd_dir)
    t_start = time.perf_counter()

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
    from repro_torch.obs import Recorder

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
    peaks: dict[str, float] = {}

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
        peaks[label] = peak
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
    # runs 1-3 are traced: prepare by phase, one fenced span an iteration
    eng = PMVEngine(edges, n, b=b, strategy="selective", backend="auto", device=dev,
                    obs=Recorder())
    spec = pagerank(n)
    res, meta, _ = drive("pagerank/selective", eng, spec, max_iters=100, tol=1e-6,
                      expect=("ell_gimv",))
    pagerank_iters = res.iterations
    prepare_phases("pagerank/selective", eng.obs, meta)
    check_trace("pagerank/selective", eng.obs)
    traces = {"pagerank/selective": eng.obs}
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
                    stream="off", device=dev, obs=Recorder())
    spec = sssp(0)
    res, meta, _ = drive("sssp/vertical", eng, spec, max_iters=100, tol=0.5,
                      expect=("ell_gimv", "scatter_combine"))
    prepare_phases("sssp/vertical", eng.obs, meta)
    obs_overhead(torch, np, "sssp/vertical", eng, spec, res, max_iters=100, tol=0.5)
    check_trace("sssp/vertical", eng.obs)
    traces["sssp/vertical"] = eng.obs
    log("explain sssp/vertical (live=True):\n" + eng.explain(spec, live=True))
    want = sssp_ref(np, sp, csgraph, edges, n, 0)
    ok = res.converged and np.array_equal(res.v.astype(np.float64), want)
    log(f"check sssp vs scipy shortest_path: reached {int(np.isfinite(want).sum())} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("sssp disagrees with scipy")
    sssp_v = res.v
    run2 = {"v": res.v, "want": want,
            "exchanged_elems": [r["exchanged_elems"] for r in res.per_iter]}
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
    sparse_scatter_phase(torch, dev, gen, n, idx_x, val_x, nl, rows)
    del idx, val, idx_x, val_x
    # the per-block launch profiler on the same engine (prepare cached)
    profiler_phase(torch, np, "sssp/vertical", eng, spec)
    del eng, fp
    torch.cuda.empty_cache()

    # -- run 3: connected components, hybrid theta=3000 -------------------------
    eng = PMVEngine(sym, n, b=b, strategy="hybrid", theta=3000.0, backend="auto",
                    stream="off", device=dev, obs=Recorder())
    spec = connected_components()
    res, meta, _ = drive("cc/hybrid", eng, spec, max_iters=100, tol=0.5,
                      expect=("ell_gimv", "dense_gimv"))
    prepare_phases("cc/hybrid", eng.obs, meta)
    check_trace("cc/hybrid", eng.obs)
    traces["cc/hybrid"] = eng.obs
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

    # -- run 4b: PageRank over the bfloat16 wire, checkpointed and resumed -------
    t = time.perf_counter()
    bf16_phase(torch, np, sp, dev, edges, n, b, rows, failures)
    log(f"bf16 phase: {time.perf_counter() - t:.1f} s")

    # -- serve: PMVServer, hybrid theta=3000, 96 RWR + 96 SSSP queries at Q=64 ---
    answers, peaks["serve"] = serve_phase(args.seed, torch, np, sp, csgraph, dev, gen, edges, n,
                                          b, 3000.0, rows, failures)
    served = (answers["sssp"][:16], [s for s, _, _ in answers["rwr"][:8]])
    spmd_hints = {"pagerank": pagerank_iters}
    # -- packed serve: the same 96 RWR queries through the packed exchange -------
    packed_serve_phase(torch, np, dev, gen, edges, n, b, 3000.0, answers["rwr"], rows, failures)
    del answers
    packed_widths_phase(torch, np, dev, gen)
    # -- disk: the out-of-core store, five solves and a serve from the same edges --
    disk_phase(torch, np, sp, csgraph, dev, edges, n, b, 3000.0, sssp_v, served, peaks, rows,
               failures, seed=args.seed, traces=traces)
    del traces
    # -- spmd: one rank per worker, NCCL at W = 1, then 8 gloo ranks on the card;
    # the hier SSSP and the serve on RMAT(scale - 2), which keeps the smoke
    # inside its time limit (every rank runs the whole host prepare) --
    t = time.perf_counter()
    spmd_nccl(torch, np, sp, csgraph, dev, args.seed, rows, failures)
    small = (rmat(args.scale - 2, 16 << (args.scale - 2), seed=args.seed), 1 << (args.scale - 2))
    spmd_gloo(torch, np, sp, csgraph, dev, edges, n, b, 3000.0, run2, served[1], rows, failures,
              small=small, hints=spmd_hints)
    log(f"spmd phase: {time.perf_counter() - t:.1f} s (card: {card})")
    del run2
    del edges, sym
    # -- stream: the bucket-streamed executor on a uniform sparse graph at b = 64,
    # at scale - 1 to keep the smoke inside its time limit --
    stream_phase(torch, np, sp, csgraph, dev, gen, args.scale - 1, args.seed, rows, failures,
                 peaks)

    if failures:
        raise SmokeError("; ".join(failures))
    out = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        row = rows[name]
        out.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    **row})
    log(f"smoke: {time.perf_counter() - t_start:.1f} s in all")
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
