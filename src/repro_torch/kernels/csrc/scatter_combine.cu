// Scatter-combine: the receive side of the compact sparse exchange,
//   r[s, n] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t],
// for sets s (receiving workers), senders k and slots t; an output row no
// slot reaches gets the identity, and idx outside [0, n_local) is dropped.
//
// Replaces the TPU kernel src/repro/kernels/scatter_combine/scatter_combine.py
// (scatter_combine_pallas / _scatter_combine_kernel), which built a one-hot
// (rows x slots) tile and reduced it on the MXU/VPU.
//
// Precondition (the layout sparse_exchange.compact_partials produces): each
// row (s, k) holds strictly ascending unique indices, padded with n_local.
// The fold is deterministic and uses no atomics: r starts at the identity,
// then one pass per sender k = 0..b-1, in order; within a pass each thread
// owns one slot (s, t) and does r[s, idx] = r[s, idx] (+) val, and no two
// threads of a pass touch the same output because the row's indices are
// unique.  The result is exact for min/max and the same bits from run to run
// for plus_times (the sum of each output is taken in sender order).
//
// Bound: device-memory bytes -- each slot's index and value are read once
// and the output written once; the passes also re-read and re-write the
// touched outputs, which stay in L2 at the exchange's sizes.
#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
fill_identity(T* __restrict__ out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads)
    out[i] = pmv::identity<S, T>();
}

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
scatter_pass(const int* __restrict__ idx, const T* __restrict__ val, T* __restrict__ out,
             int sets, int senders, int cap, int n_local, int k) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(sets) * cap) return;
  const int s = static_cast<int>(t / cap);
  const int slot = static_cast<int>(t - static_cast<long long>(s) * cap);
  const long long in = (static_cast<long long>(s) * senders + k) * cap + slot;
  const int j = __ldcs(idx + in);
  if (j >= 0 && j < n_local) {
    T* o = out + static_cast<long long>(s) * n_local + j;
    *o = pmv::combine_all<S, T>(*o, __ldcs(val + in));
  }
}

template <int S, typename T>
cudaError_t launch(const void* idx, const void* val, void* out, int sets, int senders,
                   int cap, int n_local, cudaStream_t stream) {
  auto* o = static_cast<T*>(out);
  const long long n_out = static_cast<long long>(sets) * n_local;
  const unsigned fill_grid = static_cast<unsigned>(
      (n_out + kThreads - 1) / kThreads < 65535 ? (n_out + kThreads - 1) / kThreads : 65535);
  fill_identity<S, T><<<fill_grid, kThreads, 0, stream>>>(o, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(sets) * cap;
  if (slots == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((slots + kThreads - 1) / kThreads);
  for (int k = 0; k < senders; ++k) {
    scatter_pass<S, T><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(idx), static_cast<const T*>(val), o, sets, senders, cap,
        n_local, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// idx: int32 [sets, senders, cap]; val: value type [sets, senders, cap];
// out: value type [sets, n_local].  Returns the first failing launch's
// cudaError_t, or cudaSuccess.
extern "C" int scatter_combine(const void* idx, const void* val, void* out, int sets,
                               int senders, int cap, int n_local, int semiring, int vtype,
                               void* stream) {
  if (sets <= 0 || senders <= 0 || cap < 0 || n_local <= 0) return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, idx, val, out, sets,
                                       senders, cap, n_local,
                                       static_cast<cudaStream_t>(stream)));
}
