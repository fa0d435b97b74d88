// Scatter-combine: the receive side of the compact sparse exchange,
//   r[s, n] = combineAll_{k, t : idx[s,k,t] == n} val[s,k,t],
// for sets s (receiving workers), senders k and slots t; an output row no
// slot reaches gets the identity, and idx outside [0, n_local) is dropped.
//
// Replaces the TPU kernel src/repro/kernels/scatter_combine/scatter_combine.py
// (scatter_combine_pallas / _scatter_combine_kernel), which built a one-hot
// (rows x slots) tile and reduced it on the MXU/VPU.
//
// One launch, each output written once: the tile fold of scatter_tile.cuh
// at Q = 1, the one packed_scatter_combine.cu runs on bit-packed ids.  A
// block owns one set s and a tile of kScalarTileRows consecutive output rows
// of it; the grid covers every output row, so an output no slot reaches gets
// the identity from the tile (with cap = 0 the launch writes identities
// only).  A 32-ary warp search of each sender row finds the range of slots
// whose indices fall in the tile; the block loads those slots' values (read
// once, streaming) and indices into registers, folds them into the shared
// tile in sender order, with a barrier between senders, and writes the tile
// out once, coalesced.  So no fill kernel, no re-read of an output, and no
// thread for a padding slot: the sentinel tail of a row is never folded.
//
// Precondition (the layout sparse_exchange.compact_partials produces): each
// row (s, k) holds strictly ascending indices below n_local, then only
// indices of n_local or more (the sentinel n_local).  The search needs the
// order: a row out of order gives a wrong result, not an error, and writes
// nothing outside the block's tile.  An index below 0 sorts before every
// tile and is dropped.  Uniqueness makes the fold of one sender race-free
// without atomics.  The fold order per output is identity (+) v_0 (+) v_1
// (+) ... in sender order: exact for min/max and the same bits from run to
// run for plus_times, the bits of the one-pass-per-sender kernel this
// replaced and of packed_scatter_combine.cu on the same rows.
//
// Bound: device-memory bytes -- each valid slot's index and value read once
// and the [sets, n_local] output written once.
#include "scatter_tile.cuh"

namespace {

template <int S, typename T>
__global__ void __launch_bounds__(pmv::kScalarThreads, pmv::kScalarBlocksPerSm)
scatter_combine_tile(pmv::IntIds ids, const T* __restrict__ val, T* __restrict__ out, int sets,
                     int set_slots, int senders, int n_local, int tiles_per_set) {
  extern __shared__ __align__(16) unsigned char smem[];
  pmv::tile_fold<S, T, 1, pmv::kScalarThreads, pmv::kScalarItems>(
      reinterpret_cast<T*>(smem), ids, val, out, sets, set_slots, senders, n_local, n_local,
      static_cast<long long>(sets) * n_local, 1, pmv::kScalarTileRows, tiles_per_set, 1);
}

template <int S, typename T>
cudaError_t launch(const void* idx, const void* val, void* out, int sets, int senders,
                   int cap, int n_local, cudaStream_t stream) {
  const pmv::TileLaunch L = pmv::tile_launch<T>(
      senders, n_local, static_cast<long long>(sets) * n_local, 1, pmv::kScalarTileRows);
  if (L.blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr auto kernel = scatter_combine_tile<S, T>;
  cudaError_t err = pmv::allow_smem<kernel>(L.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(L.blocks), pmv::kScalarThreads, L.smem, stream>>>(
      pmv::IntIds{static_cast<const int*>(idx)}, static_cast<const T*>(val),
      static_cast<T*>(out), sets, senders * cap, senders, n_local, L.tiles_per_set);
  return cudaGetLastError();
}

}  // namespace

// idx: int32 [sets, senders, cap]; val: value type [sets, senders, cap];
// out: value type [sets, n_local].  One launch; returns its cudaError_t.
extern "C" int scatter_combine(const void* idx, const void* val, void* out, int sets,
                               int senders, int cap, int n_local, int semiring, int vtype,
                               void* stream) {
  if (sets <= 0 || senders <= 0 || cap < 0 || n_local <= 0 ||
      static_cast<long long>(senders) * cap > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, idx, val, out, sets,
                                       senders, cap, n_local,
                                       static_cast<cudaStream_t>(stream)));
}
