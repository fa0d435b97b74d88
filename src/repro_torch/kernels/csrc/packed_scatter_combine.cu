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
// One launch, each output written once: the tile fold of scatter_tile.cuh
// at Q = 1, the one scatter_combine.cu runs on int32 indices, here reading
// each id from the words (the ids never exist as int32 in device memory).
// A block owns one set s and a tile of kScalarTileRows consecutive output
// rows of it; the tiles cover the set's n_local + 1 rows, the drop row
// included, and the grid every set the n_out outputs reach (sets past
// n_sets hold identities; outputs at n_out or more are not written).  A
// 32-ary warp search of each sender row, each lane decoding its probe from
// the words, finds the range of slots whose ids fall in the tile, ~4
// dependent loads for a row of 85K slots where a binary search takes 17;
// the block loads the ranges' values (read once, streaming) and words into
// registers, folds them into the shared tile sender by sender with a
// barrier between senders, and writes the tile out once, coalesced.  So no
// fill kernel, no re-read of an output, and the sentinel tail of a row is
// never folded.
//
// Precondition (the layout of repro_torch.exchange.plan.build_exchange): a
// set's set_slots slots are `senders` rows of p = set_slots / senders slots,
// and in each row the ids below n_local are strictly ascending and followed
// only by ids of n_local or more (each row is a sorted np.unique set padded
// with the sentinel; build_exchange refuses rows that are not, with
// plan.check_sorted_rows, and a row out of order here gives a wrong result,
// not an error).  The search needs the order; uniqueness makes the
// fold of one sender race-free without atomics.  The fold order per output
// is identity (+) v_0 (+) v_1 (+) ... in sender order, as in the sparse
// kernel (scatter_combine.cu), so the two give the same bits and plus_times
// is the same bits from run to run.
//
// Bound: device-memory bytes -- the structural slots' words and values read
// once and every output written once.
#include "scatter_tile.cuh"

namespace {

template <int S, typename T, int W>
__global__ void __launch_bounds__(pmv::kScalarThreads, pmv::kScalarBlocksPerSm)
packed_scatter_combine_tile(pmv::PackedIds<W> ids, const T* __restrict__ val,
                            T* __restrict__ out, int n_sets, int set_slots, int senders,
                            int n_local, int n_out, int tiles_per_set) {
  extern __shared__ __align__(16) unsigned char smem[];
  pmv::tile_fold<S, T, 1, pmv::kScalarThreads, pmv::kScalarItems>(
      reinterpret_cast<T*>(smem), ids, val, out, n_sets, set_slots, senders, n_local,
      n_local + 1, n_out, 1, pmv::kScalarTileRows, tiles_per_set, 1);
}

template <int S, typename T, int W>
cudaError_t launch_w(const void* words, const void* val, void* out, int n_sets,
                     int set_slots, int senders, int n_local, int n_out,
                     cudaStream_t stream) {
  if (n_out == 0) return cudaSuccess;
  const pmv::TileLaunch L = pmv::tile_launch<T>(senders, n_local + 1, n_out, 1,
                                                pmv::kScalarTileRows);
  if (L.blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  constexpr auto kernel = packed_scatter_combine_tile<S, T, W>;
  cudaError_t err = pmv::allow_smem<kernel>(L.smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(L.blocks), pmv::kScalarThreads, L.smem, stream>>>(
      pmv::PackedIds<W>{static_cast<const unsigned*>(words)}, static_cast<const T*>(val),
      static_cast<T*>(out), n_sets, set_slots, senders, n_local, n_out, L.tiles_per_set);
  return cudaGetLastError();
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
// [n_sets * set_slots]; out: value type [n_out].  One launch; returns its
// cudaError_t (cudaSuccess without a launch when n_out is 0).
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
