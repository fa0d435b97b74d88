// Multi-query packed-id scatter-combine: the receive side of the packed
// exchange when every slot carries Q payload values,
//   r[o, q] = combineAll_{t : target(t) == o} val[t, q],
// with the bit-packed targets of packed_scatter_combine.cu: words hold
// 32 / W ids each (W in {4, 8, 16, 32}), LSB first, and slot t of set
// s = t / set_slots targets id(t) + s * (n_local + 1).  An id of n_local or
// more and a target of n_out or more are dropped; an output no slot reaches
// (every set's drop slot among them) keeps the identity.
//
// Replaces the TPU kernel src/repro/kernels/scatter_combine/scatter_combine.py
// (packed_scatter_combine_multi_pallas / _packed_scatter_multi_kernel),
// which decoded a tile of ids in VMEM and reduced a one-hot (rows x slots)
// tile against a (slots, TQ) value tile on the MXU/VPU.
//
// Here a block owns a tile of kTile consecutive slots of one (set, sender)
// row and all Q columns.  Its first kTile threads decode the tile's ids,
// one word read and one shift/mask per slot (not per column), into shared
// memory; then the block walks the tile's kTile x Q values with the column
// fastest, so a warp reads 32 consecutive values of the tile's contiguous
// [kTile, Q] payload and writes 32 consecutive columns of an output row.
// Precondition and fold as in packed_scatter_combine.cu: each set's
// set_slots slots are `senders` rows whose ids below n_local are unique; r
// starts at the identity, then one pass per sender k = 0..senders-1, in
// order, with no atomics.  Exact for min/max, the same bits from run to run
// for plus_times, summed in sender order as scatter_combine_multi.cu sums.
//
// Bound: device-memory bytes -- each slot's word share and Q values are read
// once and the [n_out, Q] output written once; the passes re-read and
// re-write the touched output rows.
#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;   // slots per block

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
packed_fill_identity_multi(T* __restrict__ out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads)
    out[i] = pmv::identity<S, T>();
}

template <int S, typename T, int W>
__global__ void __launch_bounds__(kThreads)
packed_scatter_multi_pass(const unsigned* __restrict__ words, const T* __restrict__ val,
                          T* __restrict__ out, int set_slots, int p, int tiles_per_row,
                          int n_local, int n_out, int nq, int k) {
  constexpr int kPer = 32 / W;
  __shared__ int target[kTile];
  const int s = static_cast<int>(blockIdx.x / tiles_per_row);
  const int j0 = static_cast<int>(blockIdx.x - static_cast<long long>(s) * tiles_per_row) * kTile;
  const int n_tile = min(kTile, p - j0);
  const long long t0 = static_cast<long long>(s) * set_slots + static_cast<long long>(k) * p + j0;
  if (static_cast<int>(threadIdx.x) < n_tile) {
    const long long t = t0 + threadIdx.x;
    const unsigned word = __ldg(words + t / kPer);
    unsigned id;
    if constexpr (W == 32) id = word;
    else id = (word >> (static_cast<int>(t % kPer) * W)) & ((1u << W) - 1u);
    const long long o = static_cast<long long>(s) * (n_local + 1) + id;
    target[threadIdx.x] = (id < static_cast<unsigned>(n_local) && o < n_out)
                              ? static_cast<int>(o) : -1;
  }
  __syncthreads();
  const T* __restrict__ v = val + t0 * nq;
  for (int e = static_cast<int>(threadIdx.x); e < n_tile * nq; e += kThreads) {
    const int slot = e / nq;
    const int row = target[slot];
    if (row < 0) continue;
    const int q = e - slot * nq;
    T* o = out + static_cast<long long>(row) * nq + q;
    *o = pmv::combine_all<S, T>(*o, __ldcs(v + e));
  }
}

template <int S, typename T, int W>
cudaError_t launch_w(const void* words, const void* val, void* out, int n_sets,
                     int set_slots, int senders, int n_local, int n_out, int nq,
                     cudaStream_t stream) {
  auto* o = static_cast<T*>(out);
  const long long n_fill = static_cast<long long>(n_out) * nq;
  if (n_fill > 0) {
    const long long fill_blocks = (n_fill + kThreads - 1) / kThreads;
    const unsigned fill_grid = static_cast<unsigned>(fill_blocks < 65535 ? fill_blocks : 65535);
    packed_fill_identity_multi<S, T><<<fill_grid, kThreads, 0, stream>>>(o, n_fill);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int p = set_slots / senders;
  const int tiles_per_row = (p + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(n_sets) * tiles_per_row;
  if (blocks == 0 || n_fill == 0) return cudaSuccess;
  for (int k = 0; k < senders; ++k) {
    packed_scatter_multi_pass<S, T, W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const unsigned*>(words), static_cast<const T*>(val), o, set_slots, p,
        tiles_per_row, n_local, n_out, nq, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int S, typename T>
cudaError_t launch(const void* words, const void* val, void* out, int n_sets, int set_slots,
                   int senders, int n_local, int n_out, int nq, int width,
                   cudaStream_t stream) {
  switch (width) {
    case 4: return launch_w<S, T, 4>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
    case 8: return launch_w<S, T, 8>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
    case 16: return launch_w<S, T, 16>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
    case 32: return launch_w<S, T, 32>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// words: uint32 [n_sets * set_slots * width / 32]; val: value type
// [n_sets * set_slots, nq]; out: value type [n_out, nq].  Returns the first
// failing launch's cudaError_t, or cudaSuccess.
extern "C" int packed_scatter_combine_multi(const void* words, const void* val, void* out,
                                            int n_sets, int set_slots, int senders,
                                            int n_local, int n_out, int nq, int width,
                                            int semiring, int vtype, void* stream) {
  if (n_sets < 0 || set_slots <= 0 || senders <= 0 || set_slots % senders != 0 ||
      n_local <= 0 || n_out < 0 || nq <= 0)
    return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, words, val, out, n_sets,
                                       set_slots, senders, n_local, n_out, nq, width,
                                       static_cast<cudaStream_t>(stream)));
}
