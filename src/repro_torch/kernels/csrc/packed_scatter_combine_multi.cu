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
// One launch, each output written once: the tile design of
// scatter_combine_multi.cu (scatter_tile.cuh), with the ids decoded from the
// words inside the kernel (they never exist as int32 in device memory).  A
// block owns one set s, a tile of consecutive output rows of its n_local + 1
// rows (the drop row included) and a slab of up to 64 query columns; the
// grid covers every set the n_out outputs reach, so sets past n_sets hold
// identities, as in packed_scatter_combine.cu.
//
// Precondition (the layout of repro_torch.exchange.plan.build_exchange, which
// refuses rows that are not, with plan.check_sorted_rows): a set's set_slots
// slots are `senders` rows of p = set_slots / senders slots, and in each row
// the ids below n_local are strictly ascending and followed only by ids of
// n_local or more.  A row out of order gives a wrong result, not an error.
// The fold order per output is identity (+) v_0 (+) v_1 (+) ... in sender
// order, as in scatter_combine_multi.cu, so the two give the same bits and
// plus_times is the same bits from run to run.
//
// Bound: device-memory bytes -- the structural slots' words and Q values
// read once and the [n_out, Q] output written once.
#include "scatter_tile.cuh"

namespace {

template <int S, typename T, int V, int W>
__global__ void __launch_bounds__(pmv::kTileThreads, pmv::kTileBlocksPerSm)
packed_scatter_multi_tile(pmv::PackedIds<W> ids, const T* __restrict__ val,
                          T* __restrict__ out, int n_sets, int set_slots, int senders,
                          int n_local, int n_out, int nq, int tile_rows, int tiles_per_set,
                          int slabs) {
  extern __shared__ __align__(16) unsigned char smem[];
  pmv::tile_fold_multi<S, T, V>(reinterpret_cast<T*>(smem), ids, val, out, n_sets, set_slots,
                                senders, n_local, n_local + 1, n_out, nq, tile_rows,
                                tiles_per_set, slabs);
}

template <int S, typename T, int V, int W>
cudaError_t launch_vw(const void* words, const void* val, void* out, int n_sets,
                      int set_slots, int senders, int n_local, int n_out, int nq,
                      cudaStream_t stream) {
  if (n_out == 0) return cudaSuccess;
  const pmv::TileLaunch L = pmv::tile_launch<T>(senders, n_local + 1, n_out, nq);
  if (L.blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr auto kernel = packed_scatter_multi_tile<S, T, V, W>;
  cudaError_t err = pmv::allow_smem<kernel>(L.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(L.blocks), pmv::kTileThreads, L.smem, stream>>>(
      pmv::PackedIds<W>{static_cast<const unsigned*>(words)}, static_cast<const T*>(val),
      static_cast<T*>(out), n_sets, set_slots, senders, n_local, n_out, nq, L.tile_rows,
      L.tiles_per_set, L.slabs);
  return cudaGetLastError();
}

template <int S, typename T, int V>
cudaError_t launch_v(const void* words, const void* val, void* out, int n_sets,
                     int set_slots, int senders, int n_local, int n_out, int nq, int width,
                     cudaStream_t stream) {
  switch (width) {
    case 4: return launch_vw<S, T, V, 4>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
    case 8: return launch_vw<S, T, V, 8>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
    case 16: return launch_vw<S, T, V, 16>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
    case 32: return launch_vw<S, T, V, 32>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq, stream);
  }
  return cudaErrorInvalidValue;
}

template <int S, typename T>
cudaError_t launch(const void* words, const void* val, void* out, int n_sets, int set_slots,
                   int senders, int n_local, int n_out, int nq, int width,
                   cudaStream_t stream) {
  if (pmv::vec4_ok(val, out, nq))
    return launch_v<S, T, 4>(words, val, out, n_sets, set_slots, senders, n_local, n_out,
                             nq, width, stream);
  return launch_v<S, T, 1>(words, val, out, n_sets, set_slots, senders, n_local, n_out, nq,
                           width, stream);
}

}  // namespace

// words: uint32 [n_sets * set_slots * width / 32]; val: value type
// [n_sets * set_slots, nq]; out: value type [n_out, nq].  One launch; returns
// its cudaError_t (cudaSuccess without a launch when n_out is 0).
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
