// Dense GIM-V: r = M (x) v over a dense [rows, k] float matrix.
//   PLUS_TIMES  r[i] = sum_j M[i,j] * v[j]          (a matrix-vector product)
//   MIN_PLUS    r[i] = min_j M[i,j] + v[j]
//   MAX_PLUS    r[i] = max_j M[i,j] + v[j]
//   MIN_SRC     r[i] = min_{j : M[i,j] > 0} v[j]    (M is a 0/1 presence matrix)
//
// Replaces the TPU kernel src/repro/kernels/block_gimv/block_gimv.py
// (dense_gimv_pallas / _dense_gimv_kernel), which tiled M into (128, 128)
// blocks, ran plus_times on the MXU and accumulated along its column grid
// axis.  Here one warp owns one row of M: lanes read the row with 16-byte
// float4 loads (scalar loads when k is not a multiple of 4), v comes through
// the read-only cache (it is small and every warp reuses it), and a
// warp-shuffle fold applies combineAll.
//
// Bound: device-memory bytes.  Every semiring reads each matrix cell once
// (rows * k * 4 bytes) for one or two operations, far below what the card
// can compute per byte, so the work stays on CUDA cores: tensor cores would
// not move the bound of a matrix-vector product.
#include "semiring.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int S, typename T>
__device__ __forceinline__ T cell(float m, T v) {
  if constexpr (S == pmv::MIN_SRC) return m > 0.0f ? v : pmv::identity<S, T>();
  else return pmv::combine2<S, T, true>(m, v);
}

template <int S, typename T, bool VEC4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
dense_gimv_kernel(const float* __restrict__ m, const T* __restrict__ v,
                  T* __restrict__ out, long long rows, int k) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warp leaves together: one row per warp
  const float* mr = m + row * k;
  T acc = pmv::identity<S, T>();
  if constexpr (VEC4) {
    const float4* m4 = reinterpret_cast<const float4*>(mr);
    const int k4 = k >> 2;
    for (int j = lane; j < k4; j += 32) {
      const float4 q = __ldcs(m4 + j);
      const T* vj = v + 4 * j;
      acc = pmv::combine_all<S, T>(acc, cell<S, T>(q.x, __ldg(vj)));
      acc = pmv::combine_all<S, T>(acc, cell<S, T>(q.y, __ldg(vj + 1)));
      acc = pmv::combine_all<S, T>(acc, cell<S, T>(q.z, __ldg(vj + 2)));
      acc = pmv::combine_all<S, T>(acc, cell<S, T>(q.w, __ldg(vj + 3)));
    }
  } else {
    for (int j = lane; j < k; j += 32)
      acc = pmv::combine_all<S, T>(acc, cell<S, T>(__ldcs(mr + j), __ldg(v + j)));
  }
  acc = pmv::warp_combine<S, T>(acc);
  if (lane == 0) out[row] = acc;
}

template <int S, typename T>
cudaError_t launch(const void* m, const void* v, void* out, long long rows, int k,
                   cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* mm = static_cast<const float*>(m);
  const auto* vv = static_cast<const T*>(v);
  auto* o = static_cast<T*>(out);
  const bool vec4 = (k % 4 == 0) && (reinterpret_cast<uintptr_t>(m) % 16 == 0);
  if (vec4)
    dense_gimv_kernel<S, T, true><<<grid, kWarpsPerBlock * 32, 0, stream>>>(mm, vv, o, rows, k);
  else
    dense_gimv_kernel<S, T, false><<<grid, kWarpsPerBlock * 32, 0, stream>>>(mm, vv, o, rows, k);
  return cudaGetLastError();
}

}  // namespace

// m: float [rows, k]; v: value type [k]; out: value type [rows].
// Returns the launch's cudaError_t.
extern "C" int dense_gimv(const void* m, const void* v, void* out, long long rows, int k,
                          int semiring, int vtype, void* stream) {
  if (rows <= 0 || k <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, m, v, out, rows, k,
                                       static_cast<cudaStream_t>(stream)));
}
