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
// One launch, each output written once (scatter_tile.cuh): a block owns one
// set s, a tile of consecutive output rows of it (128 at Q = 64: a 32 KB
// shared tile) and a slab of up to 64 query columns (Q > 64 runs as several
// slabs in the same launch).  One warp a sender finds, by a 32-ary search of
// the sender's row, the range of slots whose indices fall in the tile; the
// block folds those slots' Q-value runs (read once, streaming, 16 bytes a
// thread where Q % 4 == 0) into the shared tile in sender order, with a
// barrier between senders, and writes the tile out once, coalesced.  So no
// fill kernel, no re-read of an output, and no thread for a padding slot:
// the sentinel tail of a row is never read.
//
// Precondition (the layout sparse_exchange.compact_partials produces, with
// one index set shared by the Q columns of a row): each row (s, k) holds
// strictly ascending indices below n_local, then only the sentinel n_local.
// The search needs the order (a row out of order gives a wrong result, not
// an error, and writes nothing outside the block's tile); uniqueness makes
// the fold of one sender race-free without atomics.  The fold order per
// output is identity (+) v_0 (+) v_1 (+) ... in sender order: exact for
// min/max and the same bits from run to run for plus_times, the bits of the
// one-pass-per-sender kernel this replaced.
//
// Bound: device-memory bytes -- each valid slot's index and Q values read
// once and the [sets, n_local, Q] output written once.
#include "scatter_tile.cuh"

namespace {

template <int S, typename T, int V>
__global__ void __launch_bounds__(pmv::kTileThreads, pmv::kTileBlocksPerSm)
scatter_multi_tile(pmv::IntIds ids, const T* __restrict__ val, T* __restrict__ out,
                   int sets, int set_slots, int senders, int n_local, int nq, int tile_rows,
                   int tiles_per_set, int slabs) {
  extern __shared__ __align__(16) unsigned char smem[];
  pmv::tile_fold<S, T, V, pmv::kTileThreads, pmv::kTileItems>(
      reinterpret_cast<T*>(smem), ids, val, out, sets, set_slots, senders, n_local, n_local,
      static_cast<long long>(sets) * n_local, nq, tile_rows, tiles_per_set, slabs);
}

template <int S, typename T, int V>
cudaError_t launch_v(const void* idx, const void* val, void* out, int sets, int senders,
                     int cap, int n_local, int nq, cudaStream_t stream) {
  const pmv::TileLaunch L = pmv::tile_launch<T>(
      senders, n_local, static_cast<long long>(sets) * n_local, nq, pmv::multi_tile_rows<T>(nq));
  if (L.blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr auto kernel = scatter_multi_tile<S, T, V>;
  cudaError_t err = pmv::allow_smem<kernel>(L.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(L.blocks), pmv::kTileThreads, L.smem, stream>>>(
      pmv::IntIds{static_cast<const int*>(idx)}, static_cast<const T*>(val),
      static_cast<T*>(out), sets, senders * cap, senders, n_local, nq, L.tile_rows,
      L.tiles_per_set, L.slabs);
  return cudaGetLastError();
}

template <int S, typename T>
cudaError_t launch(const void* idx, const void* val, void* out, int sets, int senders,
                   int cap, int n_local, int nq, cudaStream_t stream) {
  if (pmv::vec4_ok(val, out, nq))
    return launch_v<S, T, 4>(idx, val, out, sets, senders, cap, n_local, nq, stream);
  return launch_v<S, T, 1>(idx, val, out, sets, senders, cap, n_local, nq, stream);
}

}  // namespace

// idx: int32 [sets, senders, cap]; val: value type [sets, senders, cap, nq];
// out: value type [sets, n_local, nq].  One launch; returns its cudaError_t.
extern "C" int scatter_combine_multi(const void* idx, const void* val, void* out, int sets,
                                     int senders, int cap, int n_local, int nq, int semiring,
                                     int vtype, void* stream) {
  if (sets <= 0 || senders <= 0 || cap < 0 || n_local <= 0 || nq <= 0 ||
      static_cast<long long>(senders) * cap > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return static_cast<int>(PMV_DISPATCH(semiring, vtype, launch, idx, val, out, sets,
                                       senders, cap, n_local, nq,
                                       static_cast<cudaStream_t>(stream)));
}
