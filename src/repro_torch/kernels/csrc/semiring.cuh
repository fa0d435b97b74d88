// Semiring algebra shared by the GIM-V kernels (ell_gimv.cu, dense_gimv.cu,
// scatter_combine.cu).
//
// A semiring is a pair (combine2, combineAll) of the paper's GIM-V:
//   PLUS_TIMES  x = w * v,  combineAll = sum   (PageRank, RWR)
//   MIN_PLUS    x = w + v,  combineAll = min   (SSSP)
//   MAX_PLUS    x = w + v,  combineAll = max
//   MIN_SRC     x = v,      combineAll = min   (connected components)
// Values (v and the result) are float or int32; matrix values and edge
// weights are float.  For an int32 value type, combine2 is computed in float
// and converted back truncating toward zero, saturating at the int32 range
// (the same rule as the JAX package's float -> int32 conversion).
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace pmv {

enum Semiring : int { PLUS_TIMES = 0, MIN_PLUS = 1, MAX_PLUS = 2, MIN_SRC = 3 };
enum ValueType : int { VT_F32 = 0, VT_I32 = 1 };

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ int pos_inf<int>() { return INT_MAX; }

template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() { return __int_as_float(0xff800000); }
template <> __device__ __forceinline__ int neg_inf<int>() { return INT_MIN; }

// Identity of combineAll.
template <int S, typename T> __device__ __forceinline__ T identity() {
  if constexpr (S == PLUS_TIMES) return T(0);
  else if constexpr (S == MAX_PLUS) return neg_inf<T>();
  else return pos_inf<T>();
}

// combineAll of two values.
template <int S, typename T> __device__ __forceinline__ T combine_all(T a, T b) {
  if constexpr (S == PLUS_TIMES) return a + b;
  else if constexpr (S == MAX_PLUS) return b > a ? b : a;
  else return b < a ? b : a;
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
// cvt.rzi.s32.f32: round toward zero, saturating; NaN -> 0.
template <> __device__ __forceinline__ int from_float<int>(float x) { return __float2int_rz(x); }

// combine2 of a matrix value / edge weight m with a vector value v.
// HAS_W = false: the edge carries no weight and x = v.
template <int S, typename T, bool HAS_W> __device__ __forceinline__ T combine2(float m, T v) {
  if constexpr (S == MIN_SRC || !HAS_W) return v;
  else if constexpr (S == PLUS_TIMES) return from_float<T>(m * static_cast<float>(v));
  else return from_float<T>(m + static_cast<float>(v));
}

// combineAll across the 32 lanes of a warp; every lane gets the result.
template <int S, typename T> __device__ __forceinline__ T warp_combine(T acc) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    acc = combine_all<S, T>(acc, __shfl_xor_sync(0xffffffffu, acc, offset));
  return acc;
}

}  // namespace pmv

// Instantiate FN<S, T>(args...) for the runtime semiring id and value type;
// evaluates to cudaErrorInvalidValue for an unknown pair.
#define PMV_DISPATCH(semiring, vtype, FN, ...)                                  \
  ([&]() -> cudaError_t {                                                       \
    if ((vtype) == pmv::VT_F32) {                                               \
      switch (semiring) {                                                       \
        case pmv::PLUS_TIMES: return FN<pmv::PLUS_TIMES, float>(__VA_ARGS__);   \
        case pmv::MIN_PLUS: return FN<pmv::MIN_PLUS, float>(__VA_ARGS__);       \
        case pmv::MAX_PLUS: return FN<pmv::MAX_PLUS, float>(__VA_ARGS__);       \
        case pmv::MIN_SRC: return FN<pmv::MIN_SRC, float>(__VA_ARGS__);         \
      }                                                                         \
    } else if ((vtype) == pmv::VT_I32) {                                        \
      switch (semiring) {                                                       \
        case pmv::PLUS_TIMES: return FN<pmv::PLUS_TIMES, int>(__VA_ARGS__);     \
        case pmv::MIN_PLUS: return FN<pmv::MIN_PLUS, int>(__VA_ARGS__);         \
        case pmv::MAX_PLUS: return FN<pmv::MAX_PLUS, int>(__VA_ARGS__);         \
        case pmv::MIN_SRC: return FN<pmv::MIN_SRC, int>(__VA_ARGS__);           \
      }                                                                         \
    }                                                                           \
    return cudaErrorInvalidValue;                                               \
  }())
