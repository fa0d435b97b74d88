// Multi-query ELL GIM-V: r[i, q] = combineAll_d combine2(w[i,d], v[cols[i,d], q]),
// slots with cols < 0 skipped, an empty row gives the identity in every column.
// v is [N, Q] row-major (one query per column), r is [rows, Q].
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/ell_spmv.py
// (ell_gimv_multi_pallas / _ell_gimv_multi_kernel), which walked (row tile,
// query tile, degree tile) grid steps, gathered a (TR, TD, TQ) block of v
// rows into VMEM and accumulated in its output block.  Here the lanes of a
// warp map to query columns: the warp reads 32 slots of a row at once (each
// slot's col and weight loaded once, by one lane), finds the valid ones with
// a ballot, broadcasts each valid slot's (col, w) by shuffle and gathers the
// contiguous 4*Q-byte row v[col, :] with one coalesced load per 32 columns.
// The gathers of up to kGroup valid slots are issued before any is folded
// (still folded in slot order), so a warp keeps kGroup of them in flight.
// The accumulators stay in registers (QPL columns per lane); the TPU's
// sequential degree-tile axis becomes the loop over 32-slot chunks.  A Q
// wider than 32*QPL runs the row again per query tile.
//
// Precondition: every row is left-packed -- once a slot is a pad (col < 0),
// every later slot of the row is a pad.  The port's producers all give that
// (ell_from_edges puts a row's slots at offsets 0..deg-1; stacking pads are
// whole all-pad rows; flattening remaps cols in place).  A row that breaks
// it loses the slots after its first chunk that holds a pad.
//
// Bound: device-memory bytes of the slots that hold data: a row's cols up
// to its first pad (in 32-byte sectors), its valid weights, a 4*Q-byte
// gather of v per valid slot and its 4*Q-byte output row; one add or
// multiply per valid slot and column.  A row stops after the first chunk
// of cols that holds a pad, so it reads one chunk of cols per started
// chunk.  What holds the kernel on the serve's tables is the
// gathers' latency: a row's few v rows (3.5 on average in the 256-wide
// bucket of the RMAT-20 serve) are gathered at once, and the time goes to
// how many rows are in flight.  Three paths, chosen by the bucket's width,
// its rows and Q:
//
//  - width <= kHalfWidth and Q % 4 == 0 (v and out 16-byte aligned): a
//    half-warp a row, two rows in flight a warp, 16-slot chunks, each lane
//    gathering 4 columns of a v row with one 16-byte load, kHalfGroup
//    gathers in flight a half.
//  - width <= kSplitWidth otherwise, or at least as many rows as the card
//    holds warps of this path: one warp a row, 32-slot chunks, QPL columns
//    a lane, kGroup gathers in flight.
//  - otherwise: blocks of kWideWarps warps, each pass of a block
//    taking up to kWideWarps rows, as in ell_gimv.cu: a row whose first
//    chunk holds a pad is folded by the warp that read it, and each long row
//    by the whole block: warp k takes chunks k, k + kWideWarps, ... and
//    stops at its first chunk that holds a pad.  The warps' [kWideWarps,
//    32*QPL] partials are folded in shared memory in warp order.  No
//    atomics: plus_times gives the same bits on every call, in another
//    summation order than the plain version's (allclose), and the selection
//    semirings and int32 are exact.
//
// The first two fold each row's slots in row order, so every semiring gives
// the bits of the kernel that read every slot.  Their warps are resident (a
// grid-stride loop over rows), load the next row's first chunk of cols while
// they fold this one, and the next chunk of a long row (cols and weights)
// while they fold the current one.
#include "semiring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
// widest bucket still walked by one warp a row (ell_gimv.cu says why)
constexpr int kSplitWidth = 1024;
constexpr int kWideWarps = 32;
// valid slots whose v rows are gathered before folding: 8 for a warp a row,
// 2 for a half-warp a row (of 1, 2, 4 and 8, the fastest on the RMAT-20
// serve's buckets in trial builds on an H100)
constexpr int kGroup = 8;
constexpr int kHalfGroup = 2;
// widest bucket walked a half-warp a row: at most 16 chunks of 16 slots; a
// longer row keeps more gathers in flight on a whole warp
constexpr int kHalfWidth = 256;

// Fold one 32-slot chunk into acc: lane l holds slot l's col (-1 for a pad)
// and weight.  Every lane gets the same valid mask, so the loop is
// warp-uniform.
template <int S, typename T, bool HAS_W, int QPL>
__device__ __forceinline__ void fold_chunk(const T* __restrict__ v, int nq, int q0, int lane,
                                           int col, float wd, T (&acc)[QPL]) {
  unsigned valid = __ballot_sync(kFull, col >= 0);
  while (valid != 0u) {
    int src[kGroup];
    bool ok[kGroup];
    T x[kGroup][QPL];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      ok[g] = valid != 0u;
      src[g] = ok[g] ? __ffs(valid) - 1 : 0;
      valid &= valid - 1u;
      const T* vr = v + static_cast<long long>(__shfl_sync(kFull, col, src[g])) * nq;
#pragma unroll
      for (int j = 0; j < QPL; ++j) {
        const int q = q0 + j * 32 + lane;
        x[g][j] = (ok[g] && q < nq) ? __ldg(vr + q) : T(0);
      }
    }
    // the weights are shuffled only now, so their load (issued with the
    // chunk's cols) overlaps the gathers instead of holding them back
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (ok[g]) {
        const float ws = HAS_W ? __shfl_sync(kFull, wd, src[g]) : 0.0f;
#pragma unroll
        for (int j = 0; j < QPL; ++j)
          acc[j] = pmv::combine_all<S, T>(acc[j], pmv::combine2<S, T, HAS_W>(ws, x[g][j]));
      }
    }
  }
}

template <int S, typename T, bool HAS_W, int QPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_gimv_multi_kernel(const int* __restrict__ cols, const float* __restrict__ w,
                      const T* __restrict__ v, T* __restrict__ out,
                      long long rows, int width, int nq) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  // row is warp-uniform: the whole warp walks the same rows
  int first = (row < rows && lane < width) ? __ldcs(cols + row * width + lane) : -1;
  for (; row < rows; row += stride) {
    const long long next = row + stride;
    const int first_next =
        (next < rows && lane < width) ? __ldcs(cols + next * width + lane) : -1;
    const int* c = cols + row * width;
    const float* wr = HAS_W ? w + row * width : nullptr;
    T* o = out + row * nq;
    const float first_w = (HAS_W && first >= 0) ? __ldcs(wr + lane) : 0.0f;
    for (int q0 = 0; q0 < nq; q0 += 32 * QPL) {
      T acc[QPL];
#pragma unroll
      for (int j = 0; j < QPL; ++j) acc[j] = pmv::identity<S, T>();
      int col = first;
      float wd = first_w;
      for (int d0 = 0;; d0 += 32) {   // col, wd: slot d0 + lane (-1 past the width)
        const bool more = __all_sync(kFull, col >= 0) && d0 + 32 < width;
        int col_n = -1;
        float wd_n = 0.0f;
        if (more && d0 + 32 + lane < width) {
          col_n = __ldcs(c + d0 + 32 + lane);
          if (HAS_W) wd_n = __ldcs(wr + d0 + 32 + lane);
        }
        fold_chunk<S, T, HAS_W, QPL>(v, nq, q0, lane, col, wd, acc);
        if (!more) break;   // this chunk held a pad: the rest of the row is padding
        col = col_n;
        wd = wd_n;
      }
#pragma unroll
      for (int j = 0; j < QPL; ++j) {
        const int q = q0 + j * 32 + lane;
        if (q < nq) o[q] = acc[j];
      }
    }
    first = first_next;
  }
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <int S, typename T, bool HAS_W>
__device__ __forceinline__ void fold4(typename Vec4<T>::type& acc, float ws,
                                      const typename Vec4<T>::type& x) {
  acc.x = pmv::combine_all<S, T>(acc.x, pmv::combine2<S, T, HAS_W>(ws, x.x));
  acc.y = pmv::combine_all<S, T>(acc.y, pmv::combine2<S, T, HAS_W>(ws, x.y));
  acc.z = pmv::combine_all<S, T>(acc.z, pmv::combine2<S, T, HAS_W>(ws, x.z));
  acc.w = pmv::combine_all<S, T>(acc.w, pmv::combine2<S, T, HAS_W>(ws, x.w));
}

// fold_chunk for half-warp rows: each 16-lane half holds a 16-slot chunk of
// its own row (col, wd at lane l & 15) and folds 4 query columns a lane.
// The loop runs while either half has valid slots (the shuffles need all 32
// lanes); a half with none left only predicates its loads and folds off.
template <int S, typename T, bool HAS_W>
__device__ __forceinline__ void fold_chunk_half(const T* __restrict__ v, int nq, int q, int lane,
                                                int col, float wd,
                                                typename Vec4<T>::type& acc) {
  using T4 = typename Vec4<T>::type;
  unsigned valid = (__ballot_sync(kFull, col >= 0) >> (lane & 16)) & 0xffffu;
  while (__any_sync(kFull, valid != 0u)) {
    int src[kHalfGroup];
    bool ok[kHalfGroup];
    T4 x[kHalfGroup];
#pragma unroll
    for (int g = 0; g < kHalfGroup; ++g) {
      ok[g] = valid != 0u;
      src[g] = ok[g] ? __ffs(valid) - 1 : 0;
      valid &= valid - 1u;
      const long long cs = __shfl_sync(kFull, col, src[g], 16);
      x[g] = (ok[g] && q < nq) ? __ldg(reinterpret_cast<const T4*>(v + cs * nq + q)) : T4{};
    }
#pragma unroll
    for (int g = 0; g < kHalfGroup; ++g) {
      const float ws = HAS_W ? __shfl_sync(kFull, wd, src[g], 16) : 0.0f;
      if (ok[g]) fold4<S, T, HAS_W>(acc, ws, x[g]);
    }
  }
}

// The rows of a bucket up to kHalfWidth wide when Q % 4 == 0 (and v, out
// 16-byte aligned): a half-warp a row, so a warp keeps two rows' gathers in
// flight, each lane gathering 4 columns of a v row with one 16-byte load.
// A half reads 16 slots of its row at a time and stops after the first
// 16-slot chunk that holds a pad.  Slots fold in row order, as in
// ell_gimv_multi_kernel: the same bits.
template <int S, typename T, bool HAS_W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_gimv_multi_half_kernel(const int* __restrict__ cols, const float* __restrict__ w,
                           const T* __restrict__ v, T* __restrict__ out,
                           long long rows, int width, int nq) {
  using T4 = typename Vec4<T>::type;
  const int lane = threadIdx.x & 31;
  const int hl = lane & 15;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock * 2;
  long long row =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * 2 + (lane >> 4);
  int first = (row < rows && hl < width) ? __ldcs(cols + row * width + hl) : -1;
  // the whole warp loops while either half has a row
  for (; __any_sync(kFull, row < rows); row += stride) {
    const bool has = row < rows;
    const long long next = row + stride;
    const int first_next =
        (next < rows && hl < width) ? __ldcs(cols + next * width + hl) : -1;
    const int* c = cols + row * width;
    const float* wr = HAS_W ? w + row * width : nullptr;
    const float first_w = (HAS_W && first >= 0) ? __ldcs(wr + hl) : 0.0f;
    for (int q0 = 0; q0 < nq; q0 += 64) {
      const int q = q0 + 4 * hl;
      const T id = pmv::identity<S, T>();
      T4 acc{id, id, id, id};
      int col = first;
      float wd = first_w;
      for (int d0 = 0;; d0 += 16) {   // col, wd: slot d0 + hl of this half's row
        const unsigned full = (__ballot_sync(kFull, col >= 0) >> (lane & 16)) & 0xffffu;
        const bool more = full == 0xffffu && d0 + 16 < width;
        int col_n = -1;
        float wd_n = 0.0f;
        if (more && d0 + 16 + hl < width) {
          col_n = __ldcs(c + d0 + 16 + hl);
          if (HAS_W) wd_n = __ldcs(wr + d0 + 16 + hl);
        }
        fold_chunk_half<S, T, HAS_W>(v, nq, q, lane, col, wd, acc);
        if (!__any_sync(kFull, more)) break;   // both rows reached a chunk with a pad
        col = col_n;   // -1 for a half whose row ended
        wd = wd_n;
      }
      if (has && q < nq) *reinterpret_cast<T4*>(out + row * nq + q) = acc;
    }
    first = first_next;
  }
}

template <int S, typename T, bool HAS_W, int QPL>
__global__ void __launch_bounds__(kWideWarps * 32)
ell_gimv_multi_wide_kernel(const int* __restrict__ cols, const float* __restrict__ w,
                           const T* __restrict__ v, T* __restrict__ out,
                           long long rows, int width, int nq, int tile) {
  __shared__ T part[kWideWarps][32 * QPL];
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
        const float w0 = (HAS_W && c0 >= 0) ? __ldcs(w + r * width + lane) : 0.0f;
        for (int q0 = 0; q0 < nq; q0 += 32 * QPL) {
          T acc[QPL];
#pragma unroll
          for (int j = 0; j < QPL; ++j) acc[j] = pmv::identity<S, T>();
          fold_chunk<S, T, HAS_W, QPL>(v, nq, q0, lane, c0, w0, acc);
#pragma unroll
          for (int j = 0; j < QPL; ++j) {
            const int q = q0 + j * 32 + lane;
            if (q < nq) out[r * nq + q] = acc[j];
          }
        }
      }
    }
    if (lane == 0) is_long[warp] = lng;
    __syncthreads();
    // the long rows one at a time, each over every warp of the block: warp k
    // takes chunks k, k + kWideWarps, ... and stops at its first chunk that
    // holds a pad
    for (int i = 0; i < tile; ++i) {
      if (!is_long[i]) continue;   // block-uniform
      const long long row = base + i * grid;
      const int* c = cols + row * width;
      const float* wr = HAS_W ? w + row * width : nullptr;
      T* o = out + row * nq;
      for (int q0 = 0; q0 < nq; q0 += 32 * QPL) {
        T acc[QPL];
#pragma unroll
        for (int j = 0; j < QPL; ++j) acc[j] = pmv::identity<S, T>();
        int k = warp;   // < kWideWarps < chunks
        int col = __ldcs(c + k * 32 + lane);
        float wd = (HAS_W && col >= 0) ? __ldcs(wr + k * 32 + lane) : 0.0f;
        while (true) {   // col, wd: chunk k
          const int kn = k + kWideWarps;
          const bool more = __all_sync(kFull, col >= 0) && kn < chunks;
          const int dn = kn * 32 + lane;
          int col_n = -1;
          float wd_n = 0.0f;
          if (more && dn < width) {
            col_n = __ldcs(c + dn);
            if (HAS_W) wd_n = __ldcs(wr + dn);
          }
          fold_chunk<S, T, HAS_W, QPL>(v, nq, q0, lane, col, wd, acc);
          if (!more) break;   // this chunk held a pad: every later chunk of the row is padding
          k = kn;
          col = col_n;
          wd = wd_n;
        }
#pragma unroll
        for (int j = 0; j < QPL; ++j) part[warp][j * 32 + lane] = acc[j];
        __syncthreads();
        if (threadIdx.x < 32 * QPL) {
          const int t = threadIdx.x;
          T folded = part[0][t];
#pragma unroll 4
          for (int k2 = 1; k2 < kWideWarps; ++k2)
            folded = pmv::combine_all<S, T>(folded, part[k2][t]);
          if (q0 + t < nq) o[q0 + t] = folded;
        }
        __syncthreads();   // part is rewritten for the next tile or row
      }
    }
    __syncthreads();   // is_long is rewritten for the next pass
  }
}

template <int S, typename T, bool HAS_W, int QPL>
void launch_qpl(const int* c, const float* ww, const T* vv, T* o, long long rows, int width,
                int nq, cudaStream_t stream) {
  // the wide path only while the one-warp path would leave warps of the
  // card idle (ell_gimv.cu does the same)
  const long long warps = static_cast<long long>(
      pmv::resident_grid<&ell_gimv_multi_kernel<S, T, HAS_W, QPL>>(kWarpsPerBlock * 32,
                                                                   1LL << 40)) *
      kWarpsPerBlock;
  if (width > kSplitWidth && rows < warps) {
    // as many rows a pass as spread the bucket over the resident blocks, at
    // most one a warp
    const long long resident = pmv::resident_grid<&ell_gimv_multi_wide_kernel<S, T, HAS_W, QPL>>(
        kWideWarps * 32, rows);
    const long long per = (rows + resident - 1) / resident;
    const int tile = static_cast<int>(per < kWideWarps ? per : kWideWarps);
    const long long passes = (rows + tile - 1) / tile;
    const unsigned grid = static_cast<unsigned>(passes < resident ? passes : resident);
    ell_gimv_multi_wide_kernel<S, T, HAS_W, QPL><<<grid, kWideWarps * 32, 0, stream>>>(
        c, ww, vv, o, rows, width, nq, tile);
  } else {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const unsigned grid = pmv::resident_grid<&ell_gimv_multi_kernel<S, T, HAS_W, QPL>>(
        kWarpsPerBlock * 32, blocks);
    ell_gimv_multi_kernel<S, T, HAS_W, QPL><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        c, ww, vv, o, rows, width, nq);
  }
}

template <int S, typename T, int QPL>
void launch_w(const int* c, const float* ww, const T* vv, T* o, long long rows, int width,
              int nq, cudaStream_t stream) {
  if (ww != nullptr)
    launch_qpl<S, T, true, QPL>(c, ww, vv, o, rows, width, nq, stream);
  else
    launch_qpl<S, T, false, QPL>(c, ww, vv, o, rows, width, nq, stream);
}

template <int S, typename T, bool HAS_W>
void launch_half(const int* c, const float* ww, const T* vv, T* o, long long rows, int width,
                 int nq, cudaStream_t stream) {
  const long long blocks = (rows + 2 * kWarpsPerBlock - 1) / (2 * kWarpsPerBlock);
  const unsigned grid = pmv::resident_grid<&ell_gimv_multi_half_kernel<S, T, HAS_W>>(
      kWarpsPerBlock * 32, blocks);
  ell_gimv_multi_half_kernel<S, T, HAS_W><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      c, ww, vv, o, rows, width, nq);
}

template <int S, typename T>
cudaError_t launch(const void* cols, const void* w, const void* v, void* out,
                   long long rows, int width, int nq, cudaStream_t stream) {
  const auto* c = static_cast<const int*>(cols);
  const auto* ww = static_cast<const float*>(w);
  const auto* vv = static_cast<const T*>(v);
  auto* o = static_cast<T*>(out);
  const bool aligned = (reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (width <= kHalfWidth && nq % 4 == 0 && aligned) {
    if (ww != nullptr)
      launch_half<S, T, true>(c, ww, vv, o, rows, width, nq, stream);
    else
      launch_half<S, T, false>(c, ww, vv, o, rows, width, nq, stream);
  } else if (nq <= 32)
    launch_w<S, T, 1>(c, ww, vv, o, rows, width, nq, stream);
  else
    launch_w<S, T, 2>(c, ww, vv, o, rows, width, nq, stream);
  return cudaGetLastError();
}

}  // namespace

// cols: int32 [rows, width], every row left-packed; w: float [rows, width]
// or null; v: value type [N, nq] row-major; out: value type [rows, nq].
// Returns the launch's cudaError_t.
extern "C" int ell_gimv_multi(const void* cols, const void* w, const void* v, void* out,
                              long long rows, int width, int nq, int semiring, int vtype,
                              void* stream) {
  if (rows <= 0 || width <= 0 || nq <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, cols, w, v, out, rows,
                                       width, nq, static_cast<cudaStream_t>(stream)));
}
