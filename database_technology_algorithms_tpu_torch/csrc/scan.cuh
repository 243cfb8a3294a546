// K2's engine: a single-pass segmented scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016), over (flag, u32 value) pairs; and the tile
// layout, loads and block sums that K3 (compact.cu) shares.
//
// The segmented monoid: combine(a, b) = (a.f | b.f, b.f ? b.v : op(a.v, b.v)),
// identity (0, e).  A scan with no flags is a plain scan.
//
// One launch a call.  A block takes the next tile of SCAN_TILE rows from an
// atomic counter (so it waits only on tiles that started before it).  A
// thread owns SCAN_GROUPS vectors of 4 rows, warp-striped: group k of warp w
// is 128 rows, lane L holding 4, so that a warp reads and writes each group
// as one run (16-byte accesses for values, 4-byte for flags and bools) and a
// tile's loads are all issued before any is used.  The block scans the tile
// in registers (a thread's 4 rows, the warp's lanes, a carry over the
// groups, the warps' totals) and warp 0 publishes the tile's aggregate as one
// 64-bit status word (state, flag, value), written with one release store.
// Warp 0 then looks back over the earlier tiles' words 32 at a time, nearest
// first, and stops at the first inclusive prefix or at the first aggregate
// whose flag is set: nothing before a run start changes the result.  A tile
// whose first row starts a run needs no prefix and skips the look-back.  The
// block publishes its inclusive prefix and writes its results once.  The
// counter and the status words are zeroed by one cudaMemsetAsync.
//
// `reverse` gives flip(scan(flip(f), flip(v))) without flipped copies: the
// tiles are taken from the last to the first, and within a tile logical
// position p lies at row SCAN_TILE - 1 - p, so warps, groups, lanes and rows
// mirror while the accesses stay the same runs.
#pragma once

#include "common.cuh"

namespace dbt {

enum { SCAN_ADD = 0, SCAN_MIN = 1, SCAN_MAX = 2 };

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;  // rows a thread owns (K3's count: consecutive)
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int64_t SCAN_MAX_ROWS = 0x7FFFFFFF;  // rows and ranks are 32-bit

template <int OP, bool SIGNED>
struct ValOp {
  __device__ __forceinline__ static uint32_t identity() {
    if constexpr (OP == SCAN_ADD) return 0u;
    else if constexpr (OP == SCAN_MIN) return SIGNED ? 0x7FFFFFFFu : 0xFFFFFFFFu;
    else return SIGNED ? 0x80000000u : 0u;
  }
  __device__ __forceinline__ static uint32_t apply(uint32_t a, uint32_t b) {
    if constexpr (OP == SCAN_ADD) {
      return a + b;  // wraps mod 2^32, the same bits for i32 and u32
    } else if constexpr (OP == SCAN_MIN) {
      if constexpr (SIGNED) return (uint32_t)min((int32_t)a, (int32_t)b);
      else return min(a, b);
    } else {
      if constexpr (SIGNED) return (uint32_t)max((int32_t)a, (int32_t)b);
      else return max(a, b);
    }
  }
};

using SumOp = ValOp<SCAN_ADD, false>;

struct SegPair {
  uint32_t f;
  uint32_t v;
};

template <class V>
__device__ __forceinline__ SegPair seg_identity() {
  SegPair r;
  r.f = 0u;
  r.v = V::identity();
  return r;
}

template <class V>
__device__ __forceinline__ SegPair seg_combine(SegPair a, SegPair b) {
  SegPair r;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : V::apply(a.v, b.v);
  return r;
}

template <class V>
__device__ __forceinline__ SegPair warp_inclusive_scan(SegPair x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    SegPair up;
    up.f = __shfl_up_sync(FULL_MASK, x.f, d);
    up.v = __shfl_up_sync(FULL_MASK, x.v, d);
    if (lane >= d) x = seg_combine<V>(up, x);
  }
  return x;
}

// Exclusive scan of one pair per thread across the block, in thread order.
// Writes the block's total to *total.  s_warp holds 32 pairs.  Every thread
// of the block must call it.
template <class V>
__device__ SegPair block_exclusive_scan(SegPair x, SegPair* total, SegPair* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  SegPair inc = warp_inclusive_scan<V>(x);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    SegPair w = lane < nwarps ? s_warp[lane] : seg_identity<V>();
    s_warp[lane] = warp_inclusive_scan<V>(w);
  }
  __syncthreads();
  SegPair thr_excl;
  thr_excl.f = __shfl_up_sync(FULL_MASK, inc.f, 1);
  thr_excl.v = __shfl_up_sync(FULL_MASK, inc.v, 1);
  if (lane == 0) thr_excl = seg_identity<V>();
  SegPair warp_excl = warp == 0 ? seg_identity<V>() : s_warp[warp - 1];
  *total = s_warp[nwarps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return seg_combine<V>(warp_excl, thr_excl);
}

// Exclusive sum of one u32 per thread across the block; *total gets the sum.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t x, uint32_t* total,
                                                        SegPair* s_warp) {
  SegPair p, t;
  p.f = 0u;
  p.v = x;
  const uint32_t r = block_exclusive_scan<SumOp>(p, &t, s_warp).v;
  *total = t.v;
  return r;
}

// The 16 bytes of rows [row0, row0 + 16) of a byte column, byte k in byte
// k % 4 of w[k / 4]; rows at or past n read as 0.  One 16-byte access where
// the chunk is whole and its address aligned, else four 4-byte ones, else
// bytes (a view that starts 1-3 bytes past a boundary).
__device__ __forceinline__ void load_bytes16(const uint8_t* p, int64_t row0, int64_t n,
                                             uint32_t w[4]) {
  const uint8_t* q = p + row0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(q);
  if (row0 + 16 <= n && (a & 15u) == 0) {
    const uint4 x = *reinterpret_cast<const uint4*>(q);
    w[0] = x.x;
    w[1] = x.y;
    w[2] = x.z;
    w[3] = x.w;
  } else if (row0 + 16 <= n && (a & 3u) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = reinterpret_cast<const uint32_t*>(q)[k];
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (row0 + k < n) w[k >> 2] |= (uint32_t)q[k] << (8 * (k & 3));
  }
}

// Bit k set where byte k of the chunk is not 0.
__device__ __forceinline__ uint32_t byte_mask16(const uint32_t w[4]) {
  uint32_t m = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) m |= (((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) != 0u) << k;
  return m;
}

// ---------------------------------------------------------------------------
// the status words: bits 62-63 the state, bit 32 the segment flag, bits 0-31
// the value; 0 until the tile publishes

constexpr uint64_t SCAN_AGGREGATE = 1ull << 62;  // the tile's own pair
constexpr uint64_t SCAN_PREFIX = 2ull << 62;     // the pair of every row up to the tile's last
constexpr uint64_t SCAN_FLAG = 1ull << 32;

__device__ __forceinline__ uint64_t scan_status(uint64_t state, SegPair p) {
  return state | (p.f ? SCAN_FLAG : 0ull) | (uint64_t)p.v;
}

__device__ __forceinline__ void scan_publish(uint64_t* p, uint64_t s) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(s) : "memory");
}

__device__ __forceinline__ uint64_t scan_peek(const uint64_t* p) {
  uint64_t s;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(s) : "l"(p) : "memory");
  return s;
}

// The exclusive prefix of the tile in scan place t > 0, by warp 0: lane L
// reads the word of tile u - L, nearest first, and the warp waits until every
// lane up to the first stop (an inclusive prefix, an aggregate with its flag
// set, or the place before tile 0) has published; the window's pairs up to
// the stop are combined, earliest first, into what the nearer windows gave.
template <class V>
__device__ SegPair scan_lookback(const uint64_t* status, int64_t t) {
  const int lane = threadIdx.x & 31;
  SegPair acc = seg_identity<V>();  // the tiles between the window and t
  for (int64_t u = t - 1;; u -= 32) {
    const int64_t i = u - lane;
    uint64_t s;
    unsigned stops;
    while (true) {
      s = i >= 0 ? scan_peek(&status[i]) : SCAN_PREFIX;
      const unsigned ready = __ballot_sync(FULL_MASK, (s >> 62) != 0u);
      stops = __ballot_sync(FULL_MASK, (s & (SCAN_PREFIX | SCAN_FLAG)) != 0u);
      // lanes 0 to the first stop (every lane where there is none)
      const unsigned need = stops ? (2u << (__ffs(stops) - 1)) - 1u : FULL_MASK;
      if ((ready & need) == need) break;
    }
    const int first = stops ? __ffs(stops) - 1 : 31;
    SegPair p = seg_identity<V>();
    if (i >= 0 && lane <= first) {
      p.f = (s & SCAN_FLAG) ? 1u : 0u;
      p.v = (uint32_t)s;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // lane 0 ends with lanes 31..0 combined
      SegPair q;
      q.f = __shfl_down_sync(FULL_MASK, p.f, d);
      q.v = __shfl_down_sync(FULL_MASK, p.v, d);
      if (lane + d < 32) p = seg_combine<V>(q, p);
    }
    p.f = __shfl_sync(FULL_MASK, p.f, 0);
    p.v = __shfl_sync(FULL_MASK, p.v, 0);
    acc = seg_combine<V>(p, acc);
    if (stops) return acc;
  }
}

struct ScanArgs {
  const uint8_t* flags;    // run starts; null: no segments
  const void* vals;        // u32, or bytes read as 0/1 where val_bytes == 1
  uint32_t* out;
  uint64_t* status;        // [tiles], zeroed
  uint32_t* tile_counter;  // zeroed
  int64_t n;
  int64_t tiles;
  int val_bytes;
};

constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_GROUPS = SCAN_ITEMS / 4;  // 4-row vectors a thread owns

// The thread's 4-row vectors of a u32 column, vector k at row row0 + k *
// step; rows at or past n read as `fill`.  `fast` (the tile whole and the
// column 16-byte aligned): one 16-byte access a vector, every one issued
// before any is used.
__device__ __forceinline__ void load_vectors(const uint32_t* p, int64_t row0, int step, int64_t n,
                                             bool fast, uint32_t fill,
                                             uint32_t v[SCAN_GROUPS][4]) {
  if (fast) {
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + row0 + k * step);
      v[k][0] = x.x;
      v[k][1] = x.y;
      v[k][2] = x.z;
      v[k][3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + k * step + i;
        v[k][i] = r < n ? p[r] : fill;
      }
  }
}

__device__ __forceinline__ void store_vectors(uint32_t* p, int64_t row0, int step, int64_t n,
                                              bool fast, const uint32_t v[SCAN_GROUPS][4]) {
  if (fast) {
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k)
      *reinterpret_cast<uint4*>(p + row0 + k * step) =
          make_uint4(v[k][0], v[k][1], v[k][2], v[k][3]);
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + k * step + i;
        if (r < n) p[r] = v[k][i];
      }
  }
}

// The same vectors of a byte column, bit i of m[k] set where the byte of
// row row0 + k * step + i is not 0 (rows past n: 0).  `fast` (the tile whole
// and the column 4-byte aligned): one 4-byte access a vector.
__device__ __forceinline__ void load_bits(const uint8_t* p, int64_t row0, int step, int64_t n,
                                          bool fast, uint32_t m[SCAN_GROUPS]) {
  uint32_t w[SCAN_GROUPS];
  if (fast) {
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k)
      w[k] = *reinterpret_cast<const uint32_t*>(p + row0 + k * step);
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k) {
      w[k] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = row0 + k * step + i;
        if (r < n) w[k] |= (uint32_t)p[r] << (8 * i);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SCAN_GROUPS; ++k) {
    m[k] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) m[k] |= (((w[k] >> (8 * i)) & 0xFFu) != 0u) << i;
  }
}

__device__ __forceinline__ bool aligned_to(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}


template <class V, bool REVERSE>
__global__ void __launch_bounds__(SCAN_THREADS) seg_scan_kernel(ScanArgs a) {
  __shared__ SegPair s_warp[SCAN_WARPS];  // the warps' totals, then their exclusive prefixes
  __shared__ SegPair s_prefix;
  __shared__ uint32_t s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(a.tile_counter, 1u);
  __syncthreads();
  const int64_t t = s_tile;                         // the tile's place in scan order
  const int64_t j = REVERSE ? a.tiles - 1 - t : t;  // and its rows
  const int wp = REVERSE ? SCAN_WARPS - 1 - warp : warp;
  const int lp = REVERSE ? 31 - lane : lane;
  // vector k of the thread at row0 + k * step; its rows in scan order are
  // 0..3, mirrored where REVERSE (so are the groups)
  constexpr int step = REVERSE ? -128 : 128;
  const int64_t row0 = j * SCAN_TILE + (int64_t)wp * 32 * SCAN_ITEMS +
                       (REVERSE ? (SCAN_GROUPS - 1) * 128 : 0) + lp * 4;
  const bool whole = (j + 1) * SCAN_TILE <= a.n;
  uint32_t v[SCAN_GROUPS][4], fm[SCAN_GROUPS];  // the rows of each vector in row order
  if (a.val_bytes == 1) {
    uint32_t bm[SCAN_GROUPS];
    load_bits(static_cast<const uint8_t*>(a.vals), row0, step, a.n,
              whole && aligned_to(a.vals, 4), bm);
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[k][i] = row0 + k * step + i < a.n ? (bm[k] >> i) & 1u : V::identity();
  } else {
    load_vectors(static_cast<const uint32_t*>(a.vals), row0, step, a.n,
                 whole && aligned_to(a.vals, 16), V::identity(), v);
  }
  if (a.flags) {
    load_bits(a.flags, row0, step, a.n, whole && aligned_to(a.flags, 4), fm);
  } else {
#pragma unroll
    for (int k = 0; k < SCAN_GROUPS; ++k) fm[k] = 0u;
  }

  // the thread's rows, then the warp's lanes, group by group; seen bit
  // 4k + i: a run starts at or before row i of vector k, within the vector
  SegPair carry = seg_identity<V>(), excl[SCAN_GROUPS];
  uint32_t seen = 0u;
#pragma unroll
  for (int k = 0; k < SCAN_GROUPS; ++k) {
    SegPair agg = seg_identity<V>();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = REVERSE ? 3 - q : q;
      SegPair e;
      e.f = (fm[k] >> i) & 1u;
      e.v = v[k][i];
      agg = seg_combine<V>(agg, e);
      v[k][i] = agg.v;
      seen |= agg.f << (4 * k + i);
    }
    const SegPair inc = warp_inclusive_scan<V>(agg);
    SegPair ex;
    ex.f = __shfl_up_sync(FULL_MASK, inc.f, 1);
    ex.v = __shfl_up_sync(FULL_MASK, inc.v, 1);
    if (lane == 0) ex = seg_identity<V>();
    excl[k] = seg_combine<V>(carry, ex);
    SegPair group;
    group.f = __shfl_sync(FULL_MASK, inc.f, 31);
    group.v = __shfl_sync(FULL_MASK, inc.v, 31);
    carry = seg_combine<V>(carry, group);
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  if (warp == 0) {  // the warps' prefixes, the tile's aggregate, the look-back
    const SegPair w = lane < SCAN_WARPS ? s_warp[lane] : seg_identity<V>();
    const SegPair inc = warp_inclusive_scan<V>(w);
    SegPair ex;
    ex.f = __shfl_up_sync(FULL_MASK, inc.f, 1);
    ex.v = __shfl_up_sync(FULL_MASK, inc.v, 1);
    __syncwarp();
    if (lane < SCAN_WARPS) s_warp[lane] = lane == 0 ? seg_identity<V>() : ex;
    SegPair total;
    total.f = __shfl_sync(FULL_MASK, inc.f, SCAN_WARPS - 1);
    total.v = __shfl_sync(FULL_MASK, inc.v, SCAN_WARPS - 1);
    if (lane == 0) scan_publish(&a.status[t], scan_status(t == 0 ? SCAN_PREFIX : SCAN_AGGREGATE, total));
    // a tile whose first row starts a run needs no prefix
    const bool starts = __shfl_sync(FULL_MASK, (fm[0] >> (REVERSE ? 3 : 0)) & 1u, 0) != 0u;
    SegPair prefix = seg_identity<V>();
    if (t > 0 && !starts) {
      prefix = scan_lookback<V>(a.status, t);
      if (lane == 0) scan_publish(&a.status[t], scan_status(SCAN_PREFIX, seg_combine<V>(prefix, total)));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const SegPair before_warp = seg_combine<V>(s_prefix, s_warp[warp]);
#pragma unroll
  for (int k = 0; k < SCAN_GROUPS; ++k) {
    // rows before the vector's first run start take what precedes the vector
    const uint32_t before = seg_combine<V>(before_warp, excl[k]).v;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (!((seen >> (4 * k + i)) & 1u)) v[k][i] = V::apply(before, v[k][i]);
  }
  store_vectors(a.out, row0, step, a.n, whole && aligned_to(a.out, 16), v);
}

inline int64_t scan_tiles(int64_t n) { return (n + SCAN_TILE - 1) / SCAN_TILE; }

// the tile counter, a word that brings the status words to 8 bytes, and a
// 64-bit status word a tile (kernels/scan_plan.py: scan_scratch_words)
inline int64_t seg_scan_scratch_words(int64_t n) { return 2 + 2 * scan_tiles(n); }

// Inclusive segmented scan of n pairs: one memset of the scratch
// (seg_scan_scratch_words(n) words, 4-byte aligned) and one launch.  flags
// may be null (a plain scan); val_bytes is 4 (u32 values) or 1 (bytes read as
// 0/1).
template <class V>
int seg_scan_launch(const uint8_t* flags, const void* vals, int val_bytes, uint32_t* out,
                    uint32_t* scratch, int64_t n, bool reverse, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > SCAN_MAX_ROWS || (val_bytes != 1 && val_bytes != 4)) return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.flags = flags;
  a.vals = vals;
  a.out = out;
  a.tile_counter = scratch;
  a.status = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(scratch + 1) + 7u) & ~static_cast<uintptr_t>(7u));
  a.n = n;
  a.tiles = scan_tiles(n);
  a.val_bytes = val_bytes;
  cudaError_t ce = cudaMemsetAsync(scratch, 0, (size_t)seg_scan_scratch_words(n) * 4u, stream);
  if (ce != cudaSuccess) return (int)ce;
  if (reverse) seg_scan_kernel<V, true><<<(unsigned)a.tiles, SCAN_THREADS, 0, stream>>>(a);
  else seg_scan_kernel<V, false><<<(unsigned)a.tiles, SCAN_THREADS, 0, stream>>>(a);
  DBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace dbt
