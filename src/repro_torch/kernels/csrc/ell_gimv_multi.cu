// Multi-query ELL GIM-V: r[i, q] = combineAll_d combine2(w[i,d], v[cols[i,d], q]),
// slots with cols < 0 skipped, an empty row gives the identity in every column.
// v is [N, Q] row-major (one query per column), r is [rows, Q].
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/ell_spmv.py
// (ell_gimv_multi_pallas / _ell_gimv_multi_kernel), which walked (row tile,
// query tile, degree tile) grid steps, gathered a (TR, TD, TQ) block of v
// rows into VMEM and accumulated in its output block.  Here one warp owns one
// row and the lanes map to query columns: the warp reads 32 slots of the row
// at once (each slot's col and weight loaded once, by one lane), finds the
// valid ones with a ballot, and for each valid slot broadcasts (col, w) by
// shuffle and gathers the contiguous 4*Q-byte row v[col, :] with one
// coalesced load per 32 columns.  The accumulators stay in registers (QPL
// columns per lane); the TPU's sequential degree-tile axis becomes the loop
// over 32-slot chunks.  A Q wider than 32*QPL runs the row again per query
// tile.
//
// Bound: device-memory bytes.  Every slot costs its 4-byte col (read even for
// padding), a valid slot its 4-byte weight and a 4*Q-byte gather of v, each
// output row 4*Q bytes; one add or multiply per valid slot and column.  On a
// wide bucket at low occupancy the padded cols, read whole here, still carry
// most of these bytes even at Q = 64, and the [rows, Q] output most of the
// rest; the gathers of valid slots are the smaller share.  A kernel that
// stopped at a row's first all-padding chunk (rows are left-packed) would
// read one 128-byte chunk per started 32 slots instead of every col.
#include "semiring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int S, typename T, bool HAS_W, int QPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_gimv_multi_kernel(const int* __restrict__ cols, const float* __restrict__ w,
                      const T* __restrict__ v, T* __restrict__ out,
                      long long rows, int width, int nq) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together: one row per warp
  const int* c = cols + row * width;
  const float* wr = HAS_W ? w + row * width : nullptr;
  T* o = out + row * nq;
  for (int q0 = 0; q0 < nq; q0 += 32 * QPL) {
    T acc[QPL];
#pragma unroll
    for (int j = 0; j < QPL; ++j) acc[j] = pmv::identity<S, T>();
    for (int d0 = 0; d0 < width; d0 += 32) {
      const int d = d0 + lane;
      const int col = d < width ? __ldg(c + d) : -1;
      unsigned valid = __ballot_sync(kFull, col >= 0);
      if (valid == 0u) continue;  // warp-uniform: an all-padding chunk
      const float wd = (HAS_W && col >= 0) ? __ldg(wr + d) : 0.0f;
      while (valid != 0u) {  // warp-uniform loop over the chunk's valid slots
        const int src = __ffs(valid) - 1;
        valid &= valid - 1u;
        const int cs = __shfl_sync(kFull, col, src);
        const float ws = HAS_W ? __shfl_sync(kFull, wd, src) : 0.0f;
        const T* vr = v + static_cast<long long>(cs) * nq;
#pragma unroll
        for (int j = 0; j < QPL; ++j) {
          const int q = q0 + j * 32 + lane;
          if (q < nq)
            acc[j] = pmv::combine_all<S, T>(acc[j], pmv::combine2<S, T, HAS_W>(ws, __ldg(vr + q)));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QPL; ++j) {
      const int q = q0 + j * 32 + lane;
      if (q < nq) o[q] = acc[j];
    }
  }
}

template <int S, typename T, int QPL>
void launch_qpl(const int* c, const float* ww, const T* vv, T* o, long long rows, int width,
                int nq, unsigned grid, cudaStream_t stream) {
  if (ww != nullptr)
    ell_gimv_multi_kernel<S, T, true, QPL><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        c, ww, vv, o, rows, width, nq);
  else
    ell_gimv_multi_kernel<S, T, false, QPL><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        c, ww, vv, o, rows, width, nq);
}

template <int S, typename T>
cudaError_t launch(const void* cols, const void* w, const void* v, void* out,
                   long long rows, int width, int nq, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* c = static_cast<const int*>(cols);
  const auto* ww = static_cast<const float*>(w);
  const auto* vv = static_cast<const T*>(v);
  auto* o = static_cast<T*>(out);
  if (nq <= 32)
    launch_qpl<S, T, 1>(c, ww, vv, o, rows, width, nq, grid, stream);
  else
    launch_qpl<S, T, 2>(c, ww, vv, o, rows, width, nq, grid, stream);
  return cudaGetLastError();
}

}  // namespace

// cols: int32 [rows, width]; w: float [rows, width] or null; v: value type
// [N, nq] row-major; out: value type [rows, nq].  Returns the launch's
// cudaError_t.
extern "C" int ell_gimv_multi(const void* cols, const void* w, const void* v, void* out,
                              long long rows, int width, int nq, int semiring, int vtype,
                              void* stream) {
  if (rows <= 0 || width <= 0 || nq <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, cols, w, v, out, rows,
                                       width, nq, static_cast<cudaStream_t>(stream)));
}
