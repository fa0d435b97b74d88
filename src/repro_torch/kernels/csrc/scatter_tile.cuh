// The output-tile design shared by the receive-side scatter kernels
// (packed_scatter_combine.cu, scatter_combine_multi.cu,
// packed_scatter_combine_multi.cu): a block owns a tile of consecutive output
// rows of one receiving set, a warp finds each sender row's range of slots
// whose ids fall in the tile, and the block folds those ranges into the tile
// in shared memory, sender by sender, then writes the tile once.
//
// The sender rows have one layout: the ids below n_local are strictly
// ascending and followed only by ids of n_local or more (the sentinel).  Two
// readers give a slot's id from its global slot index t: IntIds (int32 ids,
// the sparse exchange's compacted rows) and PackedIds<W> (W-bit fields of
// uint32 words, LSB first, the packed exchange's).  Each read is split into
// a load (raw, shift) and a cut, so a fold can have every load of a chunk in
// flight before it cuts the first id.
#pragma once

#include "semiring.cuh"

namespace pmv {

struct IntIds {
  using id_type = int;
  const int* __restrict__ idx;
  __device__ __forceinline__ unsigned raw(long long t) const {
    return static_cast<unsigned>(__ldg(idx + t));
  }
  __device__ __forceinline__ static int shift(long long) { return 0; }
  __device__ __forceinline__ static unsigned cut(unsigned raw, int) { return raw; }
  __device__ __forceinline__ int operator()(long long t) const { return __ldg(idx + t); }
};

template <int W>
struct PackedIds {
  using id_type = unsigned;
  static constexpr int kPer = 32 / W;
  const unsigned* __restrict__ words;
  __device__ __forceinline__ unsigned raw(long long t) const { return __ldg(words + t / kPer); }
  __device__ __forceinline__ static int shift(long long t) {
    return static_cast<int>(t % kPer) * W;
  }
  __device__ __forceinline__ static unsigned cut(unsigned word, int sh) {
    if constexpr (W == 32) return word;
    else return (word >> sh) & ((1u << W) - 1u);
  }
  __device__ __forceinline__ unsigned operator()(long long t) const { return cut(raw(t), shift(t)); }
};

// First position j in [lo, hi] of the sender row starting at slot `row` whose
// id is x or more, given that the answer lies in [lo, hi] (hi = the row's
// length, or less when the caller knows more); x <= n_local, so the sentinel
// tail is "x or more".  Each step the 32 lanes probe 32 evenly spaced
// positions of the open range and a ballot keeps the one gap that holds the
// answer: ~4 dependent loads for a row of 85K slots where a binary search
// takes 17.  Every lane returns it.
template <typename Ids>
__device__ int warp_lower_bound(const Ids& ids, long long row, int lo, int hi,
                                typename Ids::id_type x, int lane) {
  while (hi > lo) {
    const long long len = hi - lo;
    const int q = lo + static_cast<int>(((lane + 1) * len) >> 5) - 1;   // in [lo - 1, hi - 1]
    const bool below = q < lo || ids(row + q) < x;
    const int c = __popc(__ballot_sync(0xffffffffu, below));          // lanes 0..c-1 below
    const int nlo = lo + static_cast<int>((c * len) >> 5);             // q_{c-1} + 1
    const int nhi = c < 32 ? lo + static_cast<int>(((c + 1) * len) >> 5) - 1 : hi;  // q_c
    lo = nlo;
    hi = nhi;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// The Q-wide tile fold (scatter_combine_multi.cu, packed_scatter_combine_multi.cu)

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTileItems = 4;        // slots per thread per chunk
constexpr int kSlabCols = 64;        // query columns per block
constexpr int kTileBytes = 32768;    // the shared tile: 128 rows at 64 float columns
constexpr int kMaxTileRows = 4096;
// Blocks an SM: four 32 KB tiles, and asking for four caps the registers at
// 64 a thread.  Chosen with tools/bench_scatter_multi.py --variants on the
// serve's buffers (PERF.md): summed over its three families 1% faster
// than 64 KB tiles at three blocks and 8 slots a thread, 3% or more faster
// than the other neighbours timed, except 40 KB tiles (0.6% faster, inside
// the rounds' spread).
constexpr int kTileBlocksPerSm = 4;

// V consecutive values of type T moved as one: V = 4 (16-byte loads and
// stores, Q % 4 == 0 and aligned pointers) or 1.
template <typename T, int V> struct Vec;
template <typename T> struct Vec<T, 1> {
  using type = T;
  __device__ __forceinline__ static T splat(T x) { return x; }
  template <int S> __device__ __forceinline__ static T combine(T a, T b) {
    return combine_all<S, T>(a, b);
  }
};
template <> struct Vec<float, 4> {
  using type = float4;
  __device__ __forceinline__ static float4 splat(float x) { return make_float4(x, x, x, x); }
  template <int S> __device__ __forceinline__ static float4 combine(float4 a, float4 b) {
    return make_float4(combine_all<S, float>(a.x, b.x), combine_all<S, float>(a.y, b.y),
                       combine_all<S, float>(a.z, b.z), combine_all<S, float>(a.w, b.w));
  }
};
template <> struct Vec<int, 4> {
  using type = int4;
  __device__ __forceinline__ static int4 splat(int x) { return make_int4(x, x, x, x); }
  template <int S> __device__ __forceinline__ static int4 combine(int4 a, int4 b) {
    return make_int4(combine_all<S, int>(a.x, b.x), combine_all<S, int>(a.y, b.y),
                     combine_all<S, int>(a.z, b.z), combine_all<S, int>(a.w, b.w));
  }
};

// One block of the Q-wide fold:
//   r[o, q] = combineAll_{slots t -> o} val[t, q]
// for the block's set s, output rows [i0, i0 + tile_rows) of the set and
// query columns [c0, c0 + cols) with c0 = slab * kSlabCols.  The set's
// set_slots slots are `senders` rows of p = set_slots / senders slots; slot
// t's values are val[t * nq + q].  Output row i of set s is out row
// s * seg_w + i (seg_w = n_local, or n_local + 1 with the packed exchange's
// drop row); rows at n_out or more are not written, and a set at n_sets or
// more holds identities only.  tile is the block's dynamic shared memory
// (tile_rows * min(nq, kSlabCols) values, then 3 * senders + 1 ints).
//
//   1. the tile's rows get the identity;
//   2. warp k % kTileWarps finds sender row k's range [lo_k, hi_k) of slots
//      whose ids fall in [i0, min(i0 + tile_rows, n_local)): lo_k by a
//      32-ary search of the row, hi_k by one of [lo_k, lo_k + tile rows]
//      (a row's ids are unique, so no more slots than rows land in a tile);
//   3. in chunks of kTileItems slots a thread, the block loads the ranges'
//      values (read once, streaming, V at a time: 2^lg threads a slot, the
//      lanes on consecutive columns) and raw ids into registers, then folds
//      them into the tile sender by sender, k = 0..senders-1, with a barrier
//      between senders: identity (+) v_0 (+) v_1 (+) ... per output, the
//      fold order of the one-pass-per-sender kernels it replaced, so the
//      same bits, plus_times included.  No atomics: a row's ids are unique.
//   4. the tile is written out once, coalesced.
// An id outside the tile (a row out of order, which the precondition
// excludes) writes nothing.
template <int S, typename T, int V, typename Ids>
__device__ __forceinline__ void tile_fold_multi(
    T* __restrict__ tile, const Ids& ids, const T* __restrict__ val, T* __restrict__ out,
    int n_sets, int set_slots, int senders, int n_local, int seg_w, long long n_out, int nq,
    int tile_rows, int tiles_per_set, int slabs) {
  using Vt = typename Vec<T, V>::type;
  const int cmax = nq < kSlabCols ? nq : kSlabCols;
  int* bnd = reinterpret_cast<int*>(tile + static_cast<long long>(tile_rows) * cmax);
  int* off = bnd + 2 * senders;   // prefix sums of the range lengths
  const int slab = static_cast<int>(blockIdx.x % slabs);
  const int st = static_cast<int>(blockIdx.x / slabs);
  const int s = st / tiles_per_set;
  const int i0 = (st - s * tiles_per_set) * tile_rows;
  const int c0 = slab * kSlabCols;
  const int cols = min(kSlabCols, nq - c0);
  const int cv = cols / V;                                  // vectors a row
  const int lg = cv <= 1 ? 0 : 32 - __clz(cv - 1);          // 2^lg >= cv threads a row
  const int per_pass = kTileThreads >> lg;                  // rows (slots) a pass
  const int col = static_cast<int>(threadIdx.x) & ((1 << lg) - 1);
  const int sub = static_cast<int>(threadIdx.x) >> lg;
  const bool col_ok = col < cv;
  const int n_here = min(tile_rows, seg_w - i0);
  const long long o0 = static_cast<long long>(s) * seg_w + i0;
  const int lane = threadIdx.x & 31;
  const int p = set_slots / senders;
  const long long set0 = static_cast<long long>(s) * set_slots;
  Vt* tv = reinterpret_cast<Vt*>(tile);                     // row r: tv[r * cv + col]

  if (col_ok)
    for (int r = sub; r < n_here; r += per_pass) tv[r * cv + col] = Vec<T, V>::splat(identity<S, T>());
  if (s < n_sets && i0 < n_local) {   // block-uniform
    const int span = min(tile_rows, n_local - i0);
    const auto x_lo = static_cast<typename Ids::id_type>(i0);
    const auto x_hi = static_cast<typename Ids::id_type>(i0 + span);
    for (int k = static_cast<int>(threadIdx.x >> 5); k < senders; k += kTileWarps) {
      const long long row = set0 + static_cast<long long>(k) * p;
      const int lo = warp_lower_bound(ids, row, 0, p, x_lo, lane);
      const int hi = warp_lower_bound(ids, row, lo, min(p, lo + span), x_hi, lane);
      if (lane == 0) {
        bnd[2 * k] = lo;
        bnd[2 * k + 1] = hi;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      off[0] = 0;
      for (int k = 0; k < senders; ++k) off[k + 1] = off[k] + bnd[2 * k + 1] - bnd[2 * k];
    }
    __syncthreads();
    const int total = off[senders];
    const int chunk = per_pass * kTileItems;
    const T* __restrict__ vcol = val + c0 + col * V;
    int k = 0;   // sender of this thread's next slot: nondecreasing, flat order is sender order
    for (int g0 = 0; g0 < total; g0 += chunk) {
      // every load of the chunk is in flight before any is used: the id is
      // cut out of its raw load only at the fold
      Vt v[kTileItems];
      unsigned raw[kTileItems];
      int shift[kTileItems];
      int from[kTileItems];
#pragma unroll
      for (int i = 0; i < kTileItems; ++i) {
        const int g = g0 + sub + i * per_pass;
        from[i] = -1;
        if (col_ok && g < total) {
          while (off[k + 1] <= g) ++k;
          const long long t = set0 + static_cast<long long>(k) * p + bnd[2 * k] + (g - off[k]);
          raw[i] = ids.raw(t);
          shift[i] = Ids::shift(t);
          v[i] = __ldcs(reinterpret_cast<const Vt*>(vcol + t * nq));
          from[i] = k;
        }
      }
      const int g1 = min(total, g0 + chunk);
      for (int ks = 0; ks < senders; ++ks) {
        if (off[ks + 1] <= g0 || off[ks] >= g1) continue;   // block-uniform
#pragma unroll
        for (int i = 0; i < kTileItems; ++i) {
          if (from[i] != ks) continue;
          // below tile_rows under the precondition; a row out of order cannot
          // write outside the tile
          const unsigned r = Ids::cut(raw[i], shift[i]) - static_cast<unsigned>(i0);
          if (r < static_cast<unsigned>(tile_rows)) {
            Vt& d = tv[r * cv + col];
            d = Vec<T, V>::template combine<S>(d, v[i]);
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  if (col_ok)
    for (int r = sub; r < n_here && o0 + r < n_out; r += per_pass)
      *reinterpret_cast<Vt*>(out + (o0 + r) * nq + c0 + col * V) = tv[r * cv + col];
}

// Grid and shared memory of a Q-wide tile launch: one block per (set, tile
// of tile_rows output rows, slab of kSlabCols columns), over every set that
// the n_out output rows reach; tile_rows fills kTileBytes with one slab's
// columns, at most kMaxTileRows.
struct TileLaunch {
  int tile_rows, tiles_per_set, slabs;
  long long blocks;
  size_t smem;
};

template <typename T>
inline TileLaunch tile_launch(int senders, int seg_w, long long n_out, int nq) {
  TileLaunch L;
  const int cmax = nq < kSlabCols ? nq : kSlabCols;
  L.tile_rows = kTileBytes / (cmax * static_cast<int>(sizeof(T)));
  if (L.tile_rows > kMaxTileRows) L.tile_rows = kMaxTileRows;
  L.tiles_per_set = (seg_w + L.tile_rows - 1) / L.tile_rows;
  L.slabs = (nq + kSlabCols - 1) / kSlabCols;
  const long long grid_sets = (n_out + seg_w - 1) / seg_w;
  L.blocks = grid_sets * L.tiles_per_set * L.slabs;
  L.smem = static_cast<size_t>(L.tile_rows) * cmax * sizeof(T) +
           (3 * static_cast<size_t>(senders) + 1) * sizeof(int);
  return L;
}

// Let Kernel take `bytes` of dynamic shared memory (above 48 KB a kernel
// must ask); asked again only for more than it was granted.
template <auto Kernel>
inline cudaError_t allow_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) granted = bytes;
  return err;
}

// V = 4 where every row's columns are 16-byte aligned in both arrays.
inline bool vec4_ok(const void* val, const void* out, int nq) {
  return nq % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(val) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

}  // namespace pmv
