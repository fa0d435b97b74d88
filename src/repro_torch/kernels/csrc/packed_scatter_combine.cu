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
// One launch, each output written once.  A block owns one set s and a tile
// of kTile consecutive output rows of it (the tiles cover the set's
// n_local + 1 rows, the drop row included; outputs at n_out or more are not
// written).  It
//   1. puts kTile identities in shared memory;
//   2. finds, for every sender k, the range [lo_k, hi_k) of sender row k
//      whose ids fall in the tile: a 32-ary search (scatter_tile.cuh) by one
//      warp per (sender, bound) pair, each lane decoding one probe from the words
//      (the ids never exist as int32 in device memory), ~4 dependent loads
//      for a row of 85K slots where a binary search takes 17;
//   3. loads the ranges' values (read once, streaming) and ids into
//      registers, kItems per thread, and folds them into the shared tile
//      sender by sender, k = 0..senders-1, with a barrier between senders;
//   4. writes the tile out once, coalesced.
// So no fill kernel, no re-read of an output, and the sentinel tail of a
// row is never read.
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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;   // output rows per block
constexpr int kItems = 8;     // slots per thread per chunk

template <int S, typename T, int W>
__global__ void __launch_bounds__(kThreads)
packed_scatter_tile(const unsigned* __restrict__ words, const T* __restrict__ val,
                    T* __restrict__ out, int n_sets, int set_slots, int senders, int n_local,
                    int n_out, int tiles_per_set) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  int* bnd = reinterpret_cast<int*>(tile + kTile);   // [lo_0, hi_0, lo_1, hi_1, ...]
  int* off = bnd + 2 * senders;                      // prefix sums of the range lengths
  const int s = static_cast<int>(blockIdx.x / tiles_per_set);
  const int i0 = static_cast<int>(blockIdx.x - s * tiles_per_set) * kTile;
  const long long o0 = static_cast<long long>(s) * (n_local + 1) + i0;
  const int n_here = min(kTile, n_local + 1 - i0);
  const int lane = threadIdx.x & 31;
  const int p = set_slots / senders;
  const long long set0 = static_cast<long long>(s) * set_slots;
  constexpr int kPer = 32 / W;
  constexpr unsigned kMask = W == 32 ? 0xffffffffu : (1u << W) - 1u;

  for (int i = threadIdx.x; i < n_here; i += kThreads) tile[i] = pmv::identity<S, T>();
  if (s < n_sets && i0 < n_local) {   // block-uniform
    const unsigned x_lo = static_cast<unsigned>(i0);
    const unsigned x_hi = static_cast<unsigned>(min(i0 + kTile, n_local));
    for (int pr = threadIdx.x >> 5; pr < 2 * senders; pr += kWarps) {
      const int k = pr >> 1;
      const int pos = pmv::warp_lower_bound(pmv::PackedIds<W>{words},
                                            set0 + static_cast<long long>(k) * p, 0, p,
                                            (pr & 1) ? x_hi : x_lo, lane);
      if (lane == 0) bnd[pr] = pos;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      off[0] = 0;
      for (int k = 0; k < senders; ++k) off[k + 1] = off[k] + bnd[2 * k + 1] - bnd[2 * k];
    }
    __syncthreads();
    const int total = off[senders];
    int k = 0;   // sender of this thread's next slot: nondecreasing, flat order is sender order
    for (int c0 = 0; c0 < total; c0 += kThreads * kItems) {
      // every load of the chunk is in flight before any is used: the id is
      // cut out of its word only at the fold
      T v[kItems];
      unsigned word[kItems];
      int shift[kItems];
      int from[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int f = c0 + static_cast<int>(threadIdx.x) + i * kThreads;
        from[i] = -1;
        if (f < total) {
          while (off[k + 1] <= f) ++k;
          const long long t = set0 + static_cast<long long>(k) * p + bnd[2 * k] + (f - off[k]);
          word[i] = __ldg(words + t / kPer);
          shift[i] = static_cast<int>(t % kPer) * W;
          v[i] = __ldcs(val + t);
          from[i] = k;
        }
      }
      const int c1 = min(total, c0 + kThreads * kItems);
      for (int ks = 0; ks < senders; ++ks) {
        if (off[ks + 1] <= c0 || off[ks] >= c1) continue;   // block-uniform
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          if (from[i] != ks) continue;
          const unsigned id = (W == 32 ? word[i] : (word[i] >> shift[i]) & kMask) - x_lo;
          // true under the precondition; a row out of order (which
          // plan.check_sorted_rows refuses) cannot write outside the tile
          if (id < static_cast<unsigned>(kTile))
            tile[id] = pmv::combine_all<S, T>(tile[id], v[i]);
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_here; i += kThreads)
    if (o0 + i < n_out) out[o0 + i] = tile[i];
}

template <int S, typename T, int W>
cudaError_t launch_w(const void* words, const void* val, void* out, int n_sets,
                     int set_slots, int senders, int n_local, int n_out,
                     cudaStream_t stream) {
  if (n_out == 0) return cudaSuccess;
  const long long seg_w = static_cast<long long>(n_local) + 1;
  const long long tiles_per_set = (seg_w + kTile - 1) / kTile;
  // every set the outputs reach; sets past n_sets (n_out beyond the
  // exchange's segments) hold identities only
  const long long grid_sets = (n_out + seg_w - 1) / seg_w;
  const long long blocks = grid_sets * tiles_per_set;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = kTile * sizeof(T) + (3 * static_cast<size_t>(senders) + 1) * sizeof(int);
  packed_scatter_tile<S, T, W><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const unsigned*>(words), static_cast<const T*>(val), static_cast<T*>(out),
      n_sets, set_slots, senders, n_local, n_out, static_cast<int>(tiles_per_set));
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
