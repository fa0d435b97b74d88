// ELL GIM-V: r[i] = combineAll_d combine2(w[i,d], v[cols[i,d]]), slots with
// cols < 0 skipped, an empty row gives the identity.
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/ell_spmv.py
// (ell_gimv_pallas / _ell_gimv_kernel), which walked (row tile, degree tile)
// grid steps and accumulated in its output block.  The TPU's sequential
// degree-tile grid axis becomes a loop over 32-slot chunks.
//
// Precondition: every row is left-packed -- once a slot is a pad (col < 0),
// every later slot of the row is a pad.  The port's producers all give that
// (ell_from_edges puts a row's slots at offsets 0..deg-1; stacking pads are
// whole all-pad rows; flattening remaps cols in place).  A row that breaks
// it loses the slots after its first chunk that holds a pad.
//
// Bound: device-memory bytes of the slots that hold data: a row's cols up
// to its first pad (in 32-byte sectors), its valid weights and the gathers
// of v; the arithmetic is one add or multiply per valid slot.  A warp stops
// after the first 32-slot chunk that holds a pad, so a row reads one
// 128-byte chunk of cols per started 32 slots (not width * 4 bytes).  Two
// paths, chosen by the bucket's width and rows:
//
//  - width <= kSplitWidth, or at least as many rows as the card holds
//    warps of this path: one warp per row, as before; the lanes stride
//    across the slots (lane l folds slots l, l + 32, ... in order, then a
//    warp-shuffle fold), so every semiring gives the bits of the kernel that
//    read every slot.  The warps are resident (a grid-stride loop over rows)
//    and load the next row's first chunk of cols while they fold this one,
//    and the next chunk of a long row while they fold the current one.
//  - otherwise: blocks of kWideWarps warps, each pass of a block taking
//    up to kWideWarps rows (as many as spread the bucket over the resident
//    blocks: one for a handful of rows, one a warp for more).  Warp
//    k reads its row's first chunk; a row whose first chunk holds a pad is
//    short and that warp folds it alone, so a bucket of short rows still
//    keeps a warp a row in flight.  Each long row is then folded by the
//    whole block: warp k takes chunks k, k + kWideWarps, ... (kUnroll of
//    them at a time, so each lane keeps kUnroll gathers in flight) and stops
//    at its first group that holds a pad; the warps' partials are folded in
//    shared memory in a fixed order.  No atomics: plus_times gives the same
//    bits on every call, in another summation order than the plain
//    version's (allclose), and the selection semirings and int32 are exact.
#include "semiring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// Widest bucket still walked by one warp a row.  The planner's lowest
// bucket holds every row below its width (on the RMAT-20 runs: 1024 wide
// for PageRank, 256 for the serve) and most of the slots, at 1-2% occupancy;
// every wider bucket holds rows longer than half its width (or stacking
// pads) and few of them, which one warp a row walks slowly (on an H100, 0.19
// ms for the 8 rows of PageRank's [8, 69017] and 4.6 ms for the serve's
// [8, 24570] at Q = 64: chip_smoke.py's bucket lines with every row on one
// warp).  A lowest bucket wider than this (a graph whose longest row is
// over 128 times it) has more rows than the card holds warps, and stays
// one warp a row.
constexpr int kSplitWidth = 1024;
constexpr int kWideWarps = 32;
constexpr int kUnroll = 4;
static_assert(kWideWarps == 32, "warp 0 folds one partial a lane");

template <int S, typename T, bool HAS_W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_gimv_kernel(const int* __restrict__ cols, const float* __restrict__ w,
                const T* __restrict__ v, T* __restrict__ out,
                long long rows, int width) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // row is warp-uniform: the whole warp walks the same rows
  int col = (row < rows && lane < width) ? __ldcs(cols + row * width + lane) : -1;
  for (; row < rows; row += stride) {
    const long long next = row + stride;
    const int col_next = (next < rows && lane < width) ? __ldcs(cols + next * width + lane) : -1;
    const int* c = cols + row * width;
    const float* wr = HAS_W ? w + row * width : nullptr;
    T acc = pmv::identity<S, T>();
    for (int d0 = 0;; d0 += 32) {   // col: slot d0 + lane, -1 past the width
      const bool more = __all_sync(kFull, col >= 0) && d0 + 32 < width;
      int col_n = -1;
      if (more && d0 + 32 + lane < width) col_n = __ldcs(c + d0 + 32 + lane);
      if (col >= 0) {
        const float wd = HAS_W ? __ldcs(wr + d0 + lane) : 0.0f;
        acc = pmv::combine_all<S, T>(acc, pmv::combine2<S, T, HAS_W>(wd, __ldg(v + col)));
      }
      if (!more) break;   // this chunk held a pad: the rest of the row is padding
      col = col_n;
    }
    acc = pmv::warp_combine<S, T>(acc);
    if (lane == 0) out[row] = acc;
    col = col_next;
  }
}

template <int S, typename T, bool HAS_W>
__global__ void __launch_bounds__(kWideWarps * 32)
ell_gimv_wide_kernel(const int* __restrict__ cols, const float* __restrict__ w,
                     const T* __restrict__ v, T* __restrict__ out,
                     long long rows, int width, int tile) {
  __shared__ T part[kWideWarps];
  __shared__ int is_long[kWideWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (width + 31) / 32;
  const long long grid = gridDim.x;
  // a pass takes the block's next `tile` rows, row base + k * grid for warp k
  // (strided, so each block gets its share of the long rows and the pads)
  for (long long base = blockIdx.x; base < rows; base += grid * tile) {
    // warp k reads its row's first chunk; a row whose first chunk holds a pad
    // ends there, and the warp folds it alone
    const long long r = base + warp * grid;
    bool lng = false;
    if (warp < tile && r < rows) {
      const int c0 = __ldg(cols + r * width + lane);   // width > kSplitWidth > 32
      lng = __all_sync(kFull, c0 >= 0);
      if (!lng) {
        T acc = pmv::identity<S, T>();
        if (c0 >= 0) {
          const float wd = HAS_W ? __ldcs(w + r * width + lane) : 0.0f;
          acc = pmv::combine_all<S, T>(acc, pmv::combine2<S, T, HAS_W>(wd, __ldg(v + c0)));
        }
        acc = pmv::warp_combine<S, T>(acc);
        if (lane == 0) out[r] = acc;
      }
    }
    if (lane == 0) is_long[warp] = lng;
    __syncthreads();
    // the long rows one at a time, each over every warp of the block: warp k
    // takes chunks k, k + kWideWarps, ... (its first chunk a cache hit for
    // the warp that read it above)
    for (int j = 0; j < tile; ++j) {
      if (!is_long[j]) continue;   // block-uniform
      const long long row = base + j * grid;
      const int* c = cols + row * width;
      const float* wr = HAS_W ? w + row * width : nullptr;
      T acc = pmv::identity<S, T>();
      for (int k0 = warp; k0 < chunks; k0 += kWideWarps * kUnroll) {
        int col[kUnroll];
        float wd[kUnroll];
        T x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int d = (k0 + u * kWideWarps) * 32 + lane;
          col[u] = d < width ? __ldcs(c + d) : -1;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int d = (k0 + u * kWideWarps) * 32 + lane;
          wd[u] = (HAS_W && col[u] >= 0) ? __ldcs(wr + d) : 0.0f;
          x[u] = col[u] >= 0 ? __ldg(v + col[u]) : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (col[u] >= 0)
            acc = pmv::combine_all<S, T>(acc, pmv::combine2<S, T, HAS_W>(wd[u], x[u]));
        // the group's chunks ascend, so a pad in its last one means a pad in
        // every later chunk of the row
        if (!__all_sync(kFull, col[kUnroll - 1] >= 0)) break;
      }
      acc = pmv::warp_combine<S, T>(acc);
      if (lane == 0) part[warp] = acc;
      __syncthreads();
      if (warp == 0) {
        const T folded = pmv::warp_combine<S, T>(part[lane]);
        if (lane == 0) out[row] = folded;
      }
      __syncthreads();   // part is rewritten for the next long row
    }
    __syncthreads();   // is_long is rewritten for the next pass
  }
}

template <int S, typename T, bool HAS_W>
cudaError_t launch_w(const int* c, const float* ww, const T* vv, T* o, long long rows,
                     int width, cudaStream_t stream) {
  // a bucket with at least as many rows as the one-warp path keeps warps
  // resident fills the card a warp a row: splitting rows would only add
  // barriers (and the lowest bucket of a graph with very long rows, wider
  // than kSplitWidth, holds many short rows)
  const long long warps = static_cast<long long>(
      pmv::resident_grid<&ell_gimv_kernel<S, T, HAS_W>>(kWarpsPerBlock * 32, 1LL << 40)) *
      kWarpsPerBlock;
  if (width > kSplitWidth && rows < warps) {
    // as many rows a pass as spread the bucket over the resident blocks, at
    // most one a warp: a handful of long rows gets a block each
    const long long resident =
        pmv::resident_grid<&ell_gimv_wide_kernel<S, T, HAS_W>>(kWideWarps * 32, rows);
    const long long per = (rows + resident - 1) / resident;
    const int tile = static_cast<int>(per < kWideWarps ? per : kWideWarps);
    const long long passes = (rows + tile - 1) / tile;
    const unsigned grid = static_cast<unsigned>(passes < resident ? passes : resident);
    ell_gimv_wide_kernel<S, T, HAS_W><<<grid, kWideWarps * 32, 0, stream>>>(
        c, ww, vv, o, rows, width, tile);
  } else {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const unsigned grid =
        pmv::resident_grid<&ell_gimv_kernel<S, T, HAS_W>>(kWarpsPerBlock * 32, blocks);
    ell_gimv_kernel<S, T, HAS_W><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        c, ww, vv, o, rows, width);
  }
  return cudaGetLastError();
}

template <int S, typename T>
cudaError_t launch(const void* cols, const void* w, const void* v, void* out,
                   long long rows, int width, cudaStream_t stream) {
  const auto* c = static_cast<const int*>(cols);
  const auto* ww = static_cast<const float*>(w);
  const auto* vv = static_cast<const T*>(v);
  auto* o = static_cast<T*>(out);
  if (w != nullptr) return launch_w<S, T, true>(c, ww, vv, o, rows, width, stream);
  return launch_w<S, T, false>(c, ww, vv, o, rows, width, stream);
}

}  // namespace

// cols: int32 [rows, width], every row left-packed; w: float [rows, width]
// or null; v: value type [N]; out: value type [rows].  Returns the launch's
// cudaError_t.
extern "C" int ell_gimv(const void* cols, const void* w, const void* v, void* out,
                        long long rows, int width, int semiring, int vtype,
                        void* stream) {
  if (rows <= 0 || width <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, cols, w, v, out, rows,
                                       width, static_cast<cudaStream_t>(stream)));
}
