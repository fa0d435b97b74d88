// ELL GIM-V: r[i] = combineAll_d combine2(w[i,d], v[cols[i,d]]), slots with
// cols < 0 skipped, an empty row gives the identity.
//
// Replaces the TPU kernel src/repro/kernels/ell_spmv/ell_spmv.py
// (ell_gimv_pallas / _ell_gimv_kernel), which walked (row tile, degree tile)
// grid steps and accumulated in its output block.  Here one warp owns one
// row: the lanes stride across the D slots, so the reads of cols and w are
// coalesced, v[col] is gathered through the read-only cache, and a
// warp-shuffle fold applies combineAll.  The TPU's sequential degree-tile
// grid axis becomes the in-warp loop.
//
// Bound: device-memory bytes.  Every slot costs its 4-byte col (read even
// for padding, which tells the warp to skip the slot), a valid slot adds its
// 4-byte weight and the gather of v; the arithmetic is one add or multiply
// per valid slot.  The planner's bucketed layout is copied as it is, so a
// narrow bucket holding mostly padding is read whole; weights of padding
// slots are never loaded.
#include "semiring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int S, typename T, bool HAS_W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_gimv_kernel(const int* __restrict__ cols, const float* __restrict__ w,
                const T* __restrict__ v, T* __restrict__ out,
                long long rows, int width) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together: one row per warp
  const int* c = cols + row * width;
  const float* wr = HAS_W ? w + row * width : nullptr;
  T acc = pmv::identity<S, T>();
  for (int d = lane; d < width; d += 32) {
    const int col = __ldcs(c + d);
    if (col >= 0) {
      const float wd = HAS_W ? __ldcs(wr + d) : 0.0f;
      acc = pmv::combine_all<S, T>(acc, pmv::combine2<S, T, HAS_W>(wd, __ldg(v + col)));
    }
  }
  acc = pmv::warp_combine<S, T>(acc);
  if (lane == 0) out[row] = acc;
}

template <int S, typename T>
cudaError_t launch(const void* cols, const void* w, const void* v, void* out,
                   long long rows, int width, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* c = static_cast<const int*>(cols);
  const auto* ww = static_cast<const float*>(w);
  const auto* vv = static_cast<const T*>(v);
  auto* o = static_cast<T*>(out);
  if (w != nullptr)
    ell_gimv_kernel<S, T, true><<<grid, kWarpsPerBlock * 32, 0, stream>>>(c, ww, vv, o, rows, width);
  else
    ell_gimv_kernel<S, T, false><<<grid, kWarpsPerBlock * 32, 0, stream>>>(c, ww, vv, o, rows, width);
  return cudaGetLastError();
}

}  // namespace

// cols: int32 [rows, width]; w: float [rows, width] or null; v: value type
// [N]; out: value type [rows].  Returns the launch's cudaError_t.
extern "C" int ell_gimv(const void* cols, const void* w, const void* v, void* out,
                        long long rows, int width, int semiring, int vtype,
                        void* stream) {
  if (rows <= 0 || width <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, cols, w, v, out, rows,
                                       width, static_cast<cudaStream_t>(stream)));
}
