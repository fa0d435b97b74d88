// Multi-query dense GIM-V: R = M (x) V over a dense [rows, k] float matrix
// and a [k, Q] row-major block of query vectors (one query per column).
//   PLUS_TIMES  R[i,q] = sum_j M[i,j] * V[j,q]          (a matrix product)
//   MIN_PLUS    R[i,q] = min_j M[i,j] + V[j,q]
//   MAX_PLUS    R[i,q] = max_j M[i,j] + V[j,q]
//   MIN_SRC     R[i,q] = min_{j : M[i,j] > 0} V[j,q]    (M is a 0/1 presence matrix)
//
// Replaces the TPU kernel src/repro/kernels/block_gimv/block_gimv.py
// (dense_gimv_multi_pallas / _dense_gimv_multi_kernel), which tiled M into
// (128, 128) blocks and V into (128, TQ) blocks, ran plus_times on the MXU
// (a dot_general at default precision: one bf16 pass) and the tropical
// semirings as a (TM, TK, TQ) broadcast on the VPU, and accumulated along
// its innermost k grid axis.
//
// Two kernels behind the one entry point, chosen by (semiring, value type):
//
// 1. plus_times over float32 values: tensor cores, 3xTF32.  Each operand x
//    is split as its fragment leaves shared memory into big = rna(x) and
//    small = rna(x - big) (rna: cvt.rna.tf32.f32's rounding), and R sums
//    small_a*big_v + big_a*small_v + big_a*big_v with
//    mma.sync.m16n8k8 tf32 (the small*small product, ~2^-22 of the
//    product, is left out).  mma.sync, not wgmma: tf32 wgmma wants both
//    operands K-major in shared memory, and V is [k, Q] row-major; here each
//    thread loads and splits its own fragments.  A block of 8 warps owns
//    128 rows x 64 columns (a 32 x 32 tile per warp) and walks k in steps
//    of 32 through a 3-stage ring of cp.async copies, so the stream of M
//    (5.2 GB at the serving shape) overlaps the products.  The tensor cores
//    truncate as they accumulate, and one running sum over k = 1232 drifted
//    low by more than the 1e-5 tolerance; so each 32-k tile sums into fresh
//    float32 partials that one FADD per tile adds to the result.  The k
//    order is fixed and there is no split-K: the same bits from call to
//    call.  Bound: device-memory bytes (M read once per 64-column tile),
//    1.62 ms at [1048576, 1232] x [1232, 64]; the three TF32 products need
//    1.0 ms at the tensor cores' 495 TFLOP/s (wgmma), and about 1.55 ms at
//    the ~320 TFLOP/s that mma.sync TF32 alone reaches on an H100 SXM
//    (tools/bench_dense_multi.py).  What holds the kernel near twice those
//    is not measured; the guess is instruction count and registers: per
//    mma it runs ~4 more instructions (the splits' integer adds and masks,
//    the shared loads, the partial adds), and 128 registers a thread (two
//    blocks an SM) leave a small spill.
//
// 2. min_plus, max_plus, min_src, and every int32 value type: CUDA cores.
//    A block of 256 threads owns 256 rows x 64 columns, each thread an
//    8 x 8 register tile (rows 8 tr + i, columns 4 tc + j and 32 + 4 tc + j).
//    The M tile stays row-major in shared memory: a thread reads 4 k of one
//    of its rows per 16-byte load, and 4 columns of one V row per 16-byte
//    load, 16 such loads per 256 cells.  A 4-stage cp.async ring of 16 k
//    feeds it, two blocks an SM.  Float min/max fold as one FMNMX, and
//    min_src over float values as an add of 0 or +inf and a min, so a float
//    cell is two lane instructions.  Bound: those two, 2 rows k Q / 33.5e12
//    per second: 4.93 ms at the serving shape.
//
// Padded cells give the identity: M past rows or k is read as 0 (zero-fill
// copies), V past k is the semiring's fill (0 for plus_times and min_src,
// where M = 0 already drops the cell; the identity for min/max_plus, which
// 0 + identity keeps), and V past Q is 0 in columns that are never stored.
// So any rows, k and Q work.  int32 values follow semiring.cuh: combine2 in
// float, truncated toward zero and saturated.
#include <type_traits>

#include "semiring.cuh"

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; a copy that is not `valid` writes zeros (its
// source is not read but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A [BM, BK] tile of M at (row0, k0) into shared memory with row stride LD:
// 16-byte copies when every row starts 16-byte aligned (k % 4 == 0 and an
// aligned base), else 4-byte copies.  Cells past rows or k are zero.
template <int BM, int BK, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void load_m_tile(float* dst, const float* __restrict__ m,
                                            long long rows, int k, long long row0, int k0) {
  if constexpr (VEC) {
    constexpr int kChunks = BM * BK / 4;
    static_assert(kChunks % THREADS == 0, "tile / threads");
#pragma unroll
    for (int it = 0; it < kChunks / THREADS; ++it) {
      const int c = static_cast<int>(threadIdx.x) + it * THREADS;
      const int r = c / (BK / 4);
      const int cc = (c % (BK / 4)) * 4;
      const long long gr = row0 + r;
      const int gk = k0 + cc;
      const bool ok = gr < rows && gk < k;
      cp_async16(dst + r * LD + cc, ok ? m + gr * k + gk : m, ok);
    }
  } else {
    static_assert(BM * BK % THREADS == 0, "tile / threads");
#pragma unroll
    for (int it = 0; it < BM * BK / THREADS; ++it) {
      const int e = static_cast<int>(threadIdx.x) + it * THREADS;
      const int r = e / BK;
      const int cc = e % BK;
      const long long gr = row0 + r;
      const int gk = k0 + cc;
      const bool ok = gr < rows && gk < k;
      cp_async4(dst + r * LD + cc, ok ? m + gr * k + gk : m, ok);
    }
  }
}

// A [BK, BN] tile of V at (k0, q0), 4-byte copies (V stays in L2); rows
// past k hold `fill`, columns past Q zero.
template <int BK, int BN, int LD, int THREADS, typename T>
__device__ __forceinline__ void load_v_tile(T* dst, const T* __restrict__ v, int k, int nq,
                                            int k0, int q0, T fill) {
  static_assert(BK * BN % THREADS == 0, "tile / threads");
#pragma unroll
  for (int it = 0; it < BK * BN / THREADS; ++it) {
    const int e = static_cast<int>(threadIdx.x) + it * THREADS;
    const int kr = e / BN;
    const int q = e % BN;
    const int gk = k0 + kr;
    const int gq = q0 + q;
    if (gk >= k) dst[kr * LD + q] = fill;
    else cp_async4(dst + kr * LD + q, gq < nq ? v + static_cast<long long>(gk) * nq + gq : v,
                   gq < nq);
  }
}

// The same V tile with 16-byte copies, when every V row starts 16-byte
// aligned (Q % 4 == 0 and an aligned base); rows past k and columns past Q
// are zero.
template <int BK, int BN, int LD, int THREADS>
__device__ __forceinline__ void load_v_tile16(float* dst, const float* __restrict__ v, int k,
                                              int nq, int k0, int q0) {
  constexpr int kChunks = BK * BN / 4;
  static_assert(kChunks % THREADS == 0, "tile / threads");
#pragma unroll
  for (int it = 0; it < kChunks / THREADS; ++it) {
    const int c = static_cast<int>(threadIdx.x) + it * THREADS;
    const int kr = c / (BN / 4);
    const int q = (c % (BN / 4)) * 4;
    const int gk = k0 + kr;
    const int gq = q0 + q;
    const bool ok = gk < k && gq < nq;
    cp_async16(dst + kr * LD + q, ok ? v + static_cast<long long>(gk) * nq + gq : v, ok);
  }
}

// ---------------------------------------------------------------------------
// 1. plus_times, float32: 3xTF32 on the tensor cores

namespace tc {
constexpr int kThreads = 256;   // 8 warps: 4 along rows x 2 along columns
constexpr int BM = 128, BN = 64, BK = 32, STAGES = 3;
constexpr int A_LD = BK + 4;    // row stride: fragment loads hit 32 distinct banks
constexpr int B_LD = BN + 8;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr size_t kSmem = STAGES * (A_STAGE + B_STAGE) * sizeof(float);
}  // namespace tc

// The split of x into TF32 operands big = rna(x) and small = rna(x - big),
// rna being cvt.rna.tf32.f32 (10 mantissa bits, to nearest, ties away from
// zero).  An mma.sync tf32 operand is read from the top 19 bits of its
// register and the low 13 are ignored, so adding half a TF32 ulp (0x1000)
// to the bits is the rounding, and only x - big needs big masked.  Integer
// adds and a mask cost less here than two cvt; the bits are cvt.rna's for
// every finite x.  For x = +-inf, small is inf - inf = NaN, so an infinite
// operand turns its whole output row or column into NaN (the plain version
// gives inf there, or NaN where it meets a 0); plus_times values are finite
// on every path, and a select to zero small would cost the hot loop an
// instruction per element.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool VEC, bool VEC_V>
__global__ void __launch_bounds__(tc::kThreads, 2)
dense_gimv_multi_tf32x3(const float* __restrict__ m, const float* __restrict__ v,
                        float* __restrict__ out, long long rows, int k, int nq) {
  using namespace tc;
  extern __shared__ __align__(16) float smem_f[];
  float* a_s = smem_f;                       // [STAGES][BM][A_LD]
  float* b_s = smem_f + STAGES * A_STAGE;    // [STAGES][BK][B_LD]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int wm = (warp & 3) * 32;
  const int wn = (warp >> 2) * 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int q0 = blockIdx.y * BN;
  const int nk = (k + BK - 1) / BK;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  auto load = [&](int stage, int kt) {
    load_m_tile<BM, BK, A_LD, kThreads, VEC>(a_s + stage * A_STAGE, m, rows, k, row0, kt * BK);
    if constexpr (VEC_V)
      load_v_tile16<BK, BN, B_LD, kThreads>(b_s + stage * B_STAGE, v, k, nq, kt * BK, q0);
    else
      load_v_tile<BK, BN, B_LD, kThreads, float>(b_s + stage * B_STAGE, v, k, nq, kt * BK, q0,
                                                 0.0f);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt is in; every warp is done with tile kt - 1
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* as = a_s + (kt % STAGES) * A_STAGE;
    const float* bs = b_s + (kt % STAGES) * B_STAGE;
    // The tensor cores' accumulation truncates, so one running sum over all
    // k drifts low.  The tile's 32 k chain through fresh partials from zero
    // instead, and an FADD (round to nearest) adds them to acc once per tile.
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      unsigned b_big[4][2], b_small[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bs + (ks + t) * B_LD + wn + j * 8 + g;
        split_tf32(p[0], b_big[j][0], b_small[j][0]);
        split_tf32(p[4 * B_LD], b_big[j][1], b_small[j][1]);
      }
      // one m-tile's A fragment at a time, its three products over the four
      // n-tiles: four independent mma between two that share a partial
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned a_big[4], a_small[4];
        const float* p = as + (wm + i * 16 + g) * A_LD + ks + t;
        split_tf32(p[0], a_big[0], a_small[0]);
        split_tf32(p[8 * A_LD], a_big[1], a_small[1]);
        split_tf32(p[4], a_big[2], a_small[2]);
        split_tf32(p[8 * A_LD + 4], a_big[3], a_small[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], a_small, b_big[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], a_big, b_small[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(part[i][j], a_big, b_big[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gr = row0 + wm + i * 16 + g + 8 * h;
      if (gr >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gq = q0 + wn + j * 8 + 2 * t + e;
          if (gq < nq) out[gr * nq + gq] = acc[i][j][2 * h + e];
        }
    }
}

// ---------------------------------------------------------------------------
// 2. the tropical semirings and int32 values: CUDA cores

namespace simt {
constexpr int kThreads = 256;   // 32 row groups x 8 column groups
constexpr int BM = 256, BN = 64, BK = 16, STAGES = 4;
constexpr int TM = 8;
constexpr int A_LD = BK + 4;    // 80-byte rows: 16-byte aligned
constexpr int B_LD = BN;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
template <typename T>
constexpr size_t smem_bytes() { return STAGES * (A_STAGE * sizeof(float) + B_STAGE * sizeof(T)); }
}  // namespace simt

// V's fill past k: 0 + fill must be the identity where M = 0 does not drop
// the cell already.
template <int S, typename T> __device__ __forceinline__ T v_fill() {
  if constexpr (S == pmv::MIN_PLUS || S == pmv::MAX_PLUS) return pmv::identity<S, T>();
  else return T(0);
}

// A matrix cell as it leaves shared memory.  min_src over float values
// turns the presence bit into 0 or +inf once per cell of M, so that each
// output cell is an add and a min as in min_plus.
template <int S, typename T> __device__ __forceinline__ float m_cell(float m) {
  if constexpr (S == pmv::MIN_SRC && std::is_same_v<T, float>)
    return m > 0.0f ? 0.0f : pmv::pos_inf<float>();
  else return m;
}

// combine2 of a matrix cell (after m_cell) with a value.
template <int S, typename T>
__device__ __forceinline__ T cell(float m, T v) {
  if constexpr (S == pmv::MIN_SRC && std::is_same_v<T, float>) return m + v;
  else if constexpr (S == pmv::MIN_SRC) return m > 0.0f ? v : pmv::identity<S, T>();
  else return pmv::combine2<S, T, true>(m, v);
}

// combineAll of the accumulator with a cell.  Float min/max as fminf/fmaxf,
// one FMNMX where `b < a ? b : a` is a compare and a select: the same value
// for any cell, since the accumulator is never NaN (it starts at the
// identity) and both keep it when the cell is NaN.
template <int S, typename T>
__device__ __forceinline__ T fold(T acc, T x) {
  if constexpr (std::is_same_v<T, float> && S != pmv::PLUS_TIMES)
    return S == pmv::MAX_PLUS ? fmaxf(acc, x) : fminf(acc, x);
  else return pmv::combine_all<S, T>(acc, x);
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <int S, typename T, bool VEC>
__global__ void __launch_bounds__(simt::kThreads, 2)
dense_gimv_multi_kernel(const float* __restrict__ m, const T* __restrict__ v,
                        T* __restrict__ out, long long rows, int k, int nq) {
  using namespace simt;
  using V4 = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem_c[];
  float* a_s = reinterpret_cast<float*>(smem_c);                // [STAGES][BM][A_LD]
  T* b_s = reinterpret_cast<T*>(a_s + STAGES * A_STAGE);        // [STAGES][BK][B_LD]
  const int tcol = threadIdx.x & 7;
  const int trow = threadIdx.x >> 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int q0 = blockIdx.y * BN;
  const int nk = (k + BK - 1) / BK;

  T acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = pmv::identity<S, T>();

  auto load = [&](int stage, int kt) {
    load_m_tile<BM, BK, A_LD, kThreads, VEC>(a_s + stage * A_STAGE, m, rows, k, row0, kt * BK);
    load_v_tile<BK, BN, B_LD, kThreads, T>(b_s + stage * B_STAGE, v, k, nq, kt * BK, q0,
                                           v_fill<S, T>());
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const float* as = a_s + (kt % STAGES) * A_STAGE + trow * TM * A_LD;
    const T* bs = b_s + (kt % STAGES) * B_STAGE + tcol * 4;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      // 4 k of each of the thread's 8 rows (8 loads of 16 bytes), then per
      // k the 8 columns of V (2 loads of 16 bytes)
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(as + i * A_LD + kq);
        a[i][0] = m_cell<S, T>(a4.x);
        a[i][1] = m_cell<S, T>(a4.y);
        a[i][2] = m_cell<S, T>(a4.z);
        a[i][3] = m_cell<S, T>(a4.w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const V4 lo = *reinterpret_cast<const V4*>(bs + (kq + j) * B_LD);
        const V4 hi = *reinterpret_cast<const V4*>(bs + (kq + j) * B_LD + 32);
        const T b[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[i][c] = fold<S, T>(acc[i][c], cell<S, T>(a[i][j], b[c]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gr = row0 + trow * TM + i;
    if (gr >= rows) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int gq = q0 + (c < 4 ? tcol * 4 + c : 32 + tcol * 4 + c - 4);
      if (gq < nq) out[gr * nq + gq] = acc[i][c];
    }
  }
}

// Dynamic shared memory above 48 KB must be asked for; a refusal is returned.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int S, typename T>
cudaError_t launch(const void* m_, const void* v_, void* out_, long long rows, int k, int nq,
                   cudaStream_t stream) {
  const auto* m = static_cast<const float*>(m_);
  const auto* v = static_cast<const T*>(v_);
  auto* out = static_cast<T*>(out_);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  if constexpr (S == pmv::PLUS_TIMES && std::is_same_v<T, float>) {
    const dim3 grid(static_cast<unsigned>((rows + tc::BM - 1) / tc::BM),
                    static_cast<unsigned>((nq + tc::BN - 1) / tc::BN));
    const bool vec_v = nq % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
    auto kernel = vec ? (vec_v ? dense_gimv_multi_tf32x3<true, true>
                               : dense_gimv_multi_tf32x3<true, false>)
                      : (vec_v ? dense_gimv_multi_tf32x3<false, true>
                               : dense_gimv_multi_tf32x3<false, false>);
    const cudaError_t err = allow_smem(kernel, tc::kSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, tc::kThreads, tc::kSmem, stream>>>(m, v, out, rows, k, nq);
  } else {
    const dim3 grid(static_cast<unsigned>((rows + simt::BM - 1) / simt::BM),
                    static_cast<unsigned>((nq + simt::BN - 1) / simt::BN));
    auto kernel = vec ? dense_gimv_multi_kernel<S, T, true> : dense_gimv_multi_kernel<S, T, false>;
    constexpr size_t smem = simt::smem_bytes<T>();
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, simt::kThreads, smem, stream>>>(m, v, out, rows, k, nq);
  }
  return cudaGetLastError();
}

}  // namespace

// m: float [rows, k]; v: value type [k, nq] row-major; out: value type
// [rows, nq].  Returns the cudaError_t of the launch (or of the
// shared-memory attribute it needs).
extern "C" int dense_gimv_multi(const void* m, const void* v, void* out, long long rows,
                                int k, int nq, int semiring, int vtype, void* stream) {
  if (rows <= 0 || k <= 0 || nq <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, m, v, out, rows, k, nq,
                                       static_cast<cudaStream_t>(stream)));
}
