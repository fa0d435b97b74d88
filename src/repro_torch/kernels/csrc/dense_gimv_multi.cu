// Multi-query dense GIM-V: R = M (x) V over a dense [rows, k] float matrix
// and a [k, Q] row-major block of query vectors (one query per column).
//   PLUS_TIMES  R[i,q] = sum_j M[i,j] * V[j,q]          (a matrix product)
//   MIN_PLUS    R[i,q] = min_j M[i,j] + V[j,q]
//   MAX_PLUS    R[i,q] = max_j M[i,j] + V[j,q]
//   MIN_SRC     R[i,q] = min_{j : M[i,j] > 0} V[j,q]    (M is a 0/1 presence matrix)
//
// Replaces the TPU kernel src/repro/kernels/block_gimv/block_gimv.py
// (dense_gimv_multi_pallas / _dense_gimv_multi_kernel), which tiled M into
// (128, 128) blocks and V into (128, TQ) blocks, ran plus_times on the MXU and
// the tropical semirings as a (TM, TK, TQ) broadcast on the VPU, and
// accumulated along its innermost k grid axis.  Here a block of 256 threads
// owns a (128-row, 64-column) output tile and walks k in steps of 16: each
// step stages a 128 x 16 tile of M (transposed, padded against bank
// conflicts) and a 16 x 64 tile of V in shared memory, and each thread folds
// an 8 x 4 register tile of outputs (rows ty + 16 i, columns tx + 16 j).
// plus_times stays in float32 FMA on CUDA cores (no TF32, no tensor cores),
// so it agrees with the float32 plain version to rounding.  Tiles past the
// edge of k are filled so that every padded cell gives the identity (M with
// the semiring's fill, V with 0), so any rows, k and Q work.
//
// Bound: operations.  At the serving shape ([1048576, 1232] x [1232, 64])
// the product does 2*rows*k*Q = 1.65e11 float operations, ~2.5 ms at 67
// TFLOP/s, against ~5.4 GB of bytes (~1.6 ms at 3.35 TB/s): each matrix
// cell is read once per 64-column query tile and used 64 times.
#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int BM = 128;        // rows per block: 16 thread rows x TM
constexpr int BQ = 64;         // columns per block: 16 thread columns x TQ
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TQ = 4;

// Matrix value of a padded cell: combine2 with V = 0 gives the identity.
template <int S> __device__ __forceinline__ float matrix_fill() {
  if constexpr (S == pmv::MIN_PLUS) return pmv::pos_inf<float>();
  else if constexpr (S == pmv::MAX_PLUS) return pmv::neg_inf<float>();
  else return 0.0f;
}

template <int S, typename T>
__device__ __forceinline__ T cell(float m, T v) {
  if constexpr (S == pmv::MIN_SRC) return m > 0.0f ? v : pmv::identity<S, T>();
  else return pmv::combine2<S, T, true>(m, v);
}

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
dense_gimv_multi_kernel(const float* __restrict__ m, const T* __restrict__ v,
                        T* __restrict__ out, long long rows, int k, int nq) {
  __shared__ float ms[BK][BM + 1];
  __shared__ T vs[BK][BQ];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int q0 = blockIdx.y * BQ;

  T acc[TM][TQ];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TQ; ++j) acc[i][j] = pmv::identity<S, T>();

  for (int k0 = 0; k0 < k; k0 += BK) {
    // M tile: a warp reads 16 consecutive k of two rows
#pragma unroll
    for (int it = 0; it < BM * BK / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / BK;
      const int kk = i - r * BK;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      ms[kk][r] = (gr < rows && gk < k) ? __ldg(m + gr * k + gk) : matrix_fill<S>();
    }
    // V tile: a warp reads 32 consecutive columns of one k
#pragma unroll
    for (int it = 0; it < BK * BQ / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int kk = i / BQ;
      const int qq = i - kk * BQ;
      const int gk = k0 + kk;
      const int gq = q0 + qq;
      vs[kk][qq] = (gk < k && gq < nq) ? __ldg(v + static_cast<long long>(gk) * nq + gq) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      T bv[TQ];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ms[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TQ; ++j) bv[j] = vs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TQ; ++j)
          acc[i][j] = pmv::combine_all<S, T>(acc[i][j], cell<S, T>(a[i], bv[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gr = row0 + ty + 16 * i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      const int gq = q0 + tx + 16 * j;
      if (gq < nq) out[gr * nq + gq] = acc[i][j];
    }
  }
}

template <int S, typename T>
cudaError_t launch(const void* m, const void* v, void* out, long long rows, int k, int nq,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM),
                  static_cast<unsigned>((nq + BQ - 1) / BQ));
  dense_gimv_multi_kernel<S, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(m), static_cast<const T*>(v), static_cast<T*>(out), rows, k,
      nq);
  return cudaGetLastError();
}

}  // namespace

// m: float [rows, k]; v: value type [k, nq] row-major; out: value type
// [rows, nq].  Returns the launch's cudaError_t.
extern "C" int dense_gimv_multi(const void* m, const void* v, void* out, long long rows,
                                int k, int nq, int semiring, int vtype, void* stream) {
  if (rows <= 0 || k <= 0 || nq <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, m, v, out, rows, k, nq,
                                       static_cast<cudaStream_t>(stream)));
}
