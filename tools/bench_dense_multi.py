"""Two readings behind the dense Q-wide kernel's plus_times numbers on an H100.

1. The rate ``mma.sync.m16n8k8`` TF32 reaches on this card: a probe kernel
   (compiled here with nvcc for sm_90a) that runs nothing but independent
   ``mma.sync`` from registers, at 128, 256 and 512 threads a block.  It is
   the ceiling of any kernel built on ``mma.sync`` TF32, which the 495
   TFLOP/s data-sheet figure (``wgmma``) is not.
2. ``dense_gimv_multi`` plus_times (3xTF32) against ``torch.matmul`` (FP32,
   TF32 off) at the serving shape [1048576, 1232] x [1232, 64], timed in
   alternating rounds with CUDA events so both see the same clocks.

Run on a machine with one CUDA card, from the repository root:

    python3 tools/bench_dense_multi.py [--rounds 6] [--reps 10]

Prints the card's name and power limit, then one JSON object.  Exits 1
without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys

from benchlib import alternate, card_line, event_ms, nvcc_libs

PROBE = r"""
#include <cuda_runtime.h>
constexpr int kAcc = 8;   // independent accumulator sets a thread
__global__ void mma_tf32_probe(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + 1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1.0f - 1e-3f * (threadIdx.x + i));
  float c[kAcc][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < kAcc; ++n)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.0f;
  for (int n = 0; n < kAcc; ++n)
    for (int e = 0; e < 4; ++e) s += c[n][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_tf32_probe_launch(void* out, int blocks, int threads, int iters,
                                     void* stream) {
  mma_tf32_probe<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""
PROBE_ACC = 8
MMA_FLOPS = 2 * 16 * 8 * 8   # one m16n8k8 for a warp


def build_probe():
    from repro_torch.kernels import build

    out_dir = build.build_dir() / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "mma_tf32_probe.cu", out_dir / "libmma_tf32_probe.so"
    src.write_text(PROBE)
    nvcc_libs({"probe": (src, lib)})
    fn = ctypes.CDLL(str(lib)).mma_tf32_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    from repro_torch.kernels import block_gimv

    print(f"card: {card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": torch.cuda.get_device_name(0)}

    probe = build_probe()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    iters = 4096
    for threads in (128, 256, 512):
        blocks = sms * 8
        out = torch.empty(blocks * threads, device=dev)

        def launch():
            rc = probe(out.data_ptr(), blocks, threads, iters, stream)
            if rc != 0:
                raise RuntimeError(f"probe launch failed: cudaError_t {rc}")

        ms = event_ms(torch, launch, 5)
        flops = blocks * (threads // 32) * iters * PROBE_ACC * MMA_FLOPS
        result[f"mma_sync_tf32_tflops_threads{threads}"] = flops / ms / 1e9

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, k, nq = 1048576, 1232, 64
    m = torch.rand((rows, k), device=dev, generator=gen)
    v = torch.rand((k, nq), device=dev, generator=gen)
    kernel = lambda: block_gimv.dense_gimv_multi(m, v, semiring="plus_times")  # noqa: E731
    matmul = lambda: torch.matmul(m, v)  # noqa: E731
    readings = alternate(torch, [("kernel", kernel), ("torch.matmul", matmul)], args.rounds,
                         args.reps)
    flops = 2 * rows * k * nq
    peak = max(result[f"mma_sync_tf32_tflops_threads{t}"] for t in (128, 256, 512))
    result.update(
        shape=[rows, k, nq], rounds=args.rounds, reps=args.reps,
        plus_times_ms=readings["kernel"], matmul_ms=readings["torch.matmul"],
        plus_times_ms_median=statistics.median(readings["kernel"]),
        matmul_ms_median=statistics.median(readings["torch.matmul"]),
        matmul_over_kernel_per_round=[b / a for a, b in zip(readings["kernel"],
                                                            readings["torch.matmul"])],
        bytes_floor_ms=(rows * k + k * nq + rows * nq) * 4 / 3.35e12 * 1e3,
        tf32x3_floor_ms_at_probe_peak=3 * flops / (peak * 1e12) * 1e3)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
