// Multi-query scatter-combine: the receive side of the compact sparse
// exchange when every shipped index carries Q payload values,
//   r[s, n, q] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t,q],
// for sets s (receiving workers), senders k, slots t and query columns q; an
// output row no slot reaches gets the identity, and idx outside
// [0, n_local) is dropped.
//
// Replaces the TPU kernel src/repro/kernels/scatter_combine/scatter_combine.py
// (scatter_combine_multi_pallas / _scatter_combine_multi_kernel), which built
// a one-hot (rows x slots) tile and reduced it against a (slots, TQ) value
// tile on the MXU/VPU, accumulating along its innermost slot grid axis.
//
// Precondition (the layout sparse_exchange.compact_partials produces, with
// one index set shared by the Q columns of a row): each row (s, k) holds
// strictly ascending unique indices, padded with n_local.  As in
// scatter_combine.cu the fold is deterministic and uses no atomics: r starts
// at the identity, then one pass per sender k = 0..b-1, in order.  Within a
// pass each thread owns one (set, slot, column) triple, the column fastest,
// so a warp reads 32 consecutive values of a slot's payload and writes 32
// consecutive columns of its output row; no two threads of a pass touch the
// same output because a row's indices are unique.  The result is exact for
// min/max and the same bits from run to run for plus_times (the sum of each
// output is taken in sender order).
//
// Bound: device-memory bytes -- each slot's index and Q values are read once
// and the [sets, n_local, Q] output written once; the passes also re-read and
// re-write the touched output rows.
#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
fill_identity_multi(T* __restrict__ out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads)
    out[i] = pmv::identity<S, T>();
}

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
scatter_multi_pass(const int* __restrict__ idx, const T* __restrict__ val, T* __restrict__ out,
                   int senders, int cap, int n_local, int nq, long long total, int k) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long sc = t / nq;              // (set, slot)
  const int q = static_cast<int>(t - sc * nq);
  const int s = static_cast<int>(sc / cap);
  const int slot = static_cast<int>(sc - static_cast<long long>(s) * cap);
  const long long in = (static_cast<long long>(s) * senders + k) * cap + slot;
  const int j = __ldg(idx + in);
  if (j >= 0 && j < n_local) {
    T* o = out + (static_cast<long long>(s) * n_local + j) * nq + q;
    *o = pmv::combine_all<S, T>(*o, __ldcs(val + in * nq + q));
  }
}

template <int S, typename T>
cudaError_t launch(const void* idx, const void* val, void* out, int sets, int senders,
                   int cap, int n_local, int nq, cudaStream_t stream) {
  auto* o = static_cast<T*>(out);
  const long long n_out = static_cast<long long>(sets) * n_local * nq;
  const long long fill_blocks = (n_out + kThreads - 1) / kThreads;
  const unsigned fill_grid = static_cast<unsigned>(fill_blocks < 65535 ? fill_blocks : 65535);
  fill_identity_multi<S, T><<<fill_grid, kThreads, 0, stream>>>(o, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(sets) * cap * nq;
  if (total == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  for (int k = 0; k < senders; ++k) {
    scatter_multi_pass<S, T><<<grid, kThreads, 0, stream>>>(
        static_cast<const int*>(idx), static_cast<const T*>(val), o, senders, cap, n_local,
        nq, total, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// idx: int32 [sets, senders, cap]; val: value type [sets, senders, cap, nq];
// out: value type [sets, n_local, nq].  Returns the first failing launch's
// cudaError_t, or cudaSuccess.
extern "C" int scatter_combine_multi(const void* idx, const void* val, void* out, int sets,
                                     int senders, int cap, int n_local, int nq, int semiring,
                                     int vtype, void* stream) {
  if (sets <= 0 || senders <= 0 || cap < 0 || n_local <= 0 || nq <= 0)
    return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, idx, val, out, sets,
                                       senders, cap, n_local, nq,
                                       static_cast<cudaStream_t>(stream)));
}
