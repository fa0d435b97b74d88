// Packed-id scatter-combine: the receive side of the packed exchange,
//   r[o] = combineAll_{t : target(t) == o} val[t],
// where slot t's destination id arrives bit-packed: words hold 32 / W ids
// each (W in {4, 8, 16, 32}), LSB first, and slot t of set s = t / set_slots
// targets id(t) + s * (n_local + 1).  An id of n_local or more (the
// sentinel padding a set's rows) and a target of n_out or more are dropped,
// so every set's drop slot (its row n_local) keeps the identity, as does any
// output no slot reaches.
//
// Replaces the TPU kernel src/repro/kernels/scatter_combine/scatter_combine.py
// (packed_scatter_combine_pallas / _packed_scatter_kernel and
// _decode_packed_ids), which decoded a tile of ids with vector shift/mask
// in VMEM and reduced a one-hot (rows x slots) tile on the MXU/VPU.
//
// Here each thread owns one slot: it reads the slot's word, shifts and masks
// its id out in registers (the ids never exist as int32 in device memory),
// and folds its value into the output.  Precondition (the layout of
// repro_torch.exchange.plan.build_exchange): a set's set_slots slots are
// `senders` rows of p = set_slots / senders slots, and the ids below n_local
// within one row are unique (each row is a sorted np.unique set padded with
// the sentinel).  The fold is then deterministic and uses no atomics, as in
// scatter_combine.cu: r starts at the identity, then one pass per sender
// k = 0..senders-1, in order; within a pass no two threads touch the same
// output.  The result is exact for min/max and the same bits from run to
// run for plus_times, summed in sender order as the sparse kernel sums them
// (the padded slots that the sparse stream drops fold in the identity here).
//
// Bound: device-memory bytes -- each slot's word share and value are read
// once and the output written once; the passes re-read and re-write the
// touched outputs, which stay in L2 at the exchange's sizes.
#include "semiring.cuh"

namespace {

constexpr int kThreads = 256;

template <int S, typename T>
__global__ void __launch_bounds__(kThreads)
packed_fill_identity(T* __restrict__ out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads)
    out[i] = pmv::identity<S, T>();
}

// The id of slot t: field t % (32 / W) of word t / (32 / W).
template <int W>
__device__ __forceinline__ unsigned decode_id(const unsigned* __restrict__ words, long long t) {
  constexpr int kPer = 32 / W;
  const unsigned word = __ldg(words + t / kPer);
  if constexpr (W == 32) return word;
  else return (word >> (static_cast<int>(t % kPer) * W)) & ((1u << W) - 1u);
}

template <int S, typename T, int W>
__global__ void __launch_bounds__(kThreads)
packed_scatter_pass(const unsigned* __restrict__ words, const T* __restrict__ val,
                    T* __restrict__ out, int n_sets, int set_slots, int p, int n_local,
                    int n_out, int k) {
  const long long u = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= static_cast<long long>(n_sets) * p) return;
  const int s = static_cast<int>(u / p);
  const int j = static_cast<int>(u - static_cast<long long>(s) * p);
  const long long t = static_cast<long long>(s) * set_slots + static_cast<long long>(k) * p + j;
  const unsigned id = decode_id<W>(words, t);
  if (id >= static_cast<unsigned>(n_local)) return;
  const long long o = static_cast<long long>(s) * (n_local + 1) + id;
  if (o >= n_out) return;
  out[o] = pmv::combine_all<S, T>(out[o], __ldcs(val + t));
}

template <int S, typename T, int W>
cudaError_t launch_w(const void* words, const void* val, void* out, int n_sets,
                     int set_slots, int senders, int n_local, int n_out,
                     cudaStream_t stream) {
  auto* o = static_cast<T*>(out);
  const long long fill_blocks = (static_cast<long long>(n_out) + kThreads - 1) / kThreads;
  const unsigned fill_grid = static_cast<unsigned>(fill_blocks < 65535 ? fill_blocks : 65535);
  if (n_out > 0) {
    packed_fill_identity<S, T><<<fill_grid, kThreads, 0, stream>>>(o, n_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int p = set_slots / senders;
  const long long slots = static_cast<long long>(n_sets) * p;
  if (slots == 0 || n_out == 0) return cudaSuccess;
  const unsigned grid = static_cast<unsigned>((slots + kThreads - 1) / kThreads);
  for (int k = 0; k < senders; ++k) {
    packed_scatter_pass<S, T, W><<<grid, kThreads, 0, stream>>>(
        static_cast<const unsigned*>(words), static_cast<const T*>(val), o, n_sets,
        set_slots, p, n_local, n_out, k);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int S, typename T>
cudaError_t launch(const void* words, const void* val, void* out, int n_sets, int set_slots,
                   int senders, int n_local, int n_out, int width, cudaStream_t stream) {
  switch (width) {
    case 4: return launch_w<S, T, 4>(words, val, out, n_sets, set_slots, senders, n_local, n_out, stream);
    case 8: return launch_w<S, T, 8>(words, val, out, n_sets, set_slots, senders, n_local, n_out, stream);
    case 16: return launch_w<S, T, 16>(words, val, out, n_sets, set_slots, senders, n_local, n_out, stream);
    case 32: return launch_w<S, T, 32>(words, val, out, n_sets, set_slots, senders, n_local, n_out, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// words: uint32 [n_sets * set_slots * width / 32]; val: value type
// [n_sets * set_slots]; out: value type [n_out].  Returns the first failing
// launch's cudaError_t, or cudaSuccess.
extern "C" int packed_scatter_combine(const void* words, const void* val, void* out,
                                      int n_sets, int set_slots, int senders, int n_local,
                                      int n_out, int width, int semiring, int vtype,
                                      void* stream) {
  if (n_sets < 0 || set_slots <= 0 || senders <= 0 || set_slots % senders != 0 ||
      n_local <= 0 || n_out < 0)
    return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, words, val, out, n_sets,
                                       set_slots, senders, n_local, n_out, width,
                                       static_cast<cudaStream_t>(stream)));
}
