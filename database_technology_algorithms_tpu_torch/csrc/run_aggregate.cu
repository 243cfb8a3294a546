// K13: the run aggregate.
//
// Replaces the JAX package's _run_aggregates tail (ops/aggregate.py:46-75):
// over rows in key order, the count, the u32 sum, the unsigned min and the
// unsigned max of each run of equal keys among the active rows, written
// group-major, and the number of groups.  There it is two cumsums, a
// segmented min, a segmented max, a four-word compaction of the run ends
// and neighbour differences: six passes over the sorted rows.
//
// Group g is the g-th run of new_run = active & ~adj, and row i belongs to
// group (the run starts up to and including i) - 1 (rows before the first
// start to none).  Inactive rows add the identities.
//
// Bound on the H100: bytes.  Per row it reads two 1-byte flags and one (num)
// or four (partials) 4-byte measures, and it writes four words a row of the
// output: each group's aggregate, and the identities (0, 0, 0xFFFFFFFF, 0)
// past n_groups.  Two launches and one small memset, each output word
// written once:
// - run_aggregate_kernel: one pass over tiles of TILE rows (a block takes
//   the next tile from a counter; a thread owns ITEMS consecutive rows, read
//   by 16-byte loads, so the scans across lanes cost a sixteenth of a row).
//   It reads active and adj itself, so no launch before it derives new_run
//   or the group ids.  The element of the scan is (starts, open group's
//   count, sum, min, max): starts add; the open group's aggregate restarts
//   after a start and combines otherwise (count and sum mod 2^32, min and
//   max unsigned), an associative monoid.  The block scans its tile in
//   registers (a thread's rows, the warp's lanes, the warps' totals) and
//   finds its exclusive prefix by decoupled look-back over the earlier
//   tiles' records, a warp's 32 at a time, back to the first inclusive
//   prefix (the starts are a plain sum, so no start stops it early).  A
//   record is a state word, zeroed by the memset and set by a release store
//   after its payload, and two payloads (the tile's aggregate, its
//   inclusive prefix).  Then the row that ends a group (the next row starts
//   one, or none follows) holds the group's whole aggregate and stores its
//   four words at its group id, through shared memory: the groups that end
//   in a tile have consecutive ids, so the block stores them as four
//   coalesced runs.  The tile that holds the last row writes n_groups.  A
//   tile without an active row (the inactive tail that a filter's static
//   capacity leaves) reads no measure: only its last row may end a group,
//   the one open since before it.
// - identity_tail: reads n_groups on the device and writes the identities
//   to rows [n_groups, n) of the four columns; blocks below it return.
#include "scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;              // consecutive rows a thread
constexpr int TILE = THREADS * ITEMS;  // rows a block (kernels/run_aggregate.py TILE_ROWS)
constexpr uint32_t STATE_AGGREGATE = 1u;  // the tile's own part is in agg[t]
constexpr uint32_t STATE_PREFIX = 2u;     // every row up to the tile's last is in prefix[t]
constexpr int PART_WORDS = 8;             // a payload's words: n, c, s, mn, mx, 3 unused
constexpr int TAIL_ROWS = 16;             // rows a thread of identity_tail
constexpr int STAGE = TILE + 1;           // ids of the groups that can end in a tile
constexpr int STAGE_BYTES = 4 * STAGE * 4;  // their four words, in dynamic shared memory

struct Part {
  uint32_t n;               // run starts
  uint32_t c, s, mn, mx;    // the open group's aggregate: rows after the last start
};

__device__ __forceinline__ Part identity() { return {0u, 0u, 0u, 0xFFFFFFFFu, 0u}; }

// a, then b
__device__ __forceinline__ Part combine(const Part& a, const Part& b) {
  if (b.n) return {a.n + b.n, b.c, b.s, b.mn, b.mx};
  return {a.n, a.c + b.c, a.s + b.s, min(a.mn, b.mn), max(a.mx, b.mx)};
}

__device__ __forceinline__ Part shfl(const Part& v, int src) {
  return {__shfl_sync(dbt::FULL_MASK, v.n, src), __shfl_sync(dbt::FULL_MASK, v.c, src),
          __shfl_sync(dbt::FULL_MASK, v.s, src), __shfl_sync(dbt::FULL_MASK, v.mn, src),
          __shfl_sync(dbt::FULL_MASK, v.mx, src)};
}

__device__ __forceinline__ Part shfl_up(const Part& v, int d) {
  return {__shfl_up_sync(dbt::FULL_MASK, v.n, d), __shfl_up_sync(dbt::FULL_MASK, v.c, d),
          __shfl_up_sync(dbt::FULL_MASK, v.s, d), __shfl_up_sync(dbt::FULL_MASK, v.mn, d),
          __shfl_up_sync(dbt::FULL_MASK, v.mx, d)};
}

__device__ __forceinline__ Part shfl_down(const Part& v, int d) {
  return {__shfl_down_sync(dbt::FULL_MASK, v.n, d), __shfl_down_sync(dbt::FULL_MASK, v.c, d),
          __shfl_down_sync(dbt::FULL_MASK, v.s, d), __shfl_down_sync(dbt::FULL_MASK, v.mn, d),
          __shfl_down_sync(dbt::FULL_MASK, v.mx, d)};
}

__device__ __forceinline__ Part warp_inclusive(Part x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Part up = shfl_up(x, d);
    if (lane >= d) x = combine(up, x);
  }
  return x;
}

__device__ __forceinline__ void put_part(uint32_t* p, const Part& v) {
  p[0] = v.n;
  p[1] = v.c;
  p[2] = v.s;
  p[3] = v.mn;
  p[4] = v.mx;
}

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ Part get_part(const uint32_t* p) {
  return {ld_relaxed(p), ld_relaxed(p + 1), ld_relaxed(p + 2), ld_relaxed(p + 3),
          ld_relaxed(p + 4)};
}

struct Args {
  const uint8_t* active;
  const uint8_t* adj;
  const uint32_t* v[4];  // num alone, or count, sum, min, max
  uint32_t* out[4];      // count, sum, min, max, each [n]
  int32_t* n_groups;
  uint32_t* tile_counter;  // zeroed
  uint32_t* state;         // [tiles], zeroed
  uint32_t* agg;           // [tiles][PART_WORDS]
  uint32_t* prefix;        // [tiles][PART_WORDS]
  int64_t n;
};

// The exclusive prefix of tile t > 0, by warp 0: lane L reads the record of
// tile u - L, nearest first; the warp waits until every lane up to the first
// inclusive prefix (or the place before tile 0) has published, and combines
// the window's parts up to it, earliest first, into what the nearer windows
// gave.
__device__ Part lookback(const Args& a, int64_t t) {
  const int lane = threadIdx.x & 31;
  Part acc = identity();  // the tiles between the window and t
  for (int64_t u = t - 1;; u -= 32) {
    const int64_t i = u - lane;
    uint32_t st;
    unsigned stops;
    while (true) {
      st = i >= 0 ? ld_acquire(a.state + i) : STATE_PREFIX;
      const unsigned ready = __ballot_sync(dbt::FULL_MASK, st != 0u);
      stops = __ballot_sync(dbt::FULL_MASK, st == STATE_PREFIX);
      const unsigned need = stops ? (2u << (__ffs(stops) - 1)) - 1u : dbt::FULL_MASK;
      if ((ready & need) == need) break;
    }
    const int first = stops ? __ffs(stops) - 1 : 31;
    Part p = identity();
    if (i >= 0 && lane <= first)
      p = get_part((st == STATE_PREFIX ? a.prefix : a.agg) + i * PART_WORDS);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {  // lane 0 ends with lanes 31..0 combined
      const Part q = shfl_down(p, d);
      if (lane + d < 32) p = combine(q, p);
    }
    acc = combine(shfl(p, 0), acc);
    if (stops) return acc;
  }
}

// A thread's 16 consecutive rows of a u32 column; rows at or past n read
// as 0.  `fast` (the rows whole and the column 16-byte aligned): four
// 16-byte loads.
__device__ __forceinline__ void load_rows(const uint32_t* p, int64_t row0, int64_t n, bool fast,
                                          uint32_t v[ITEMS]) {
  if (fast) {
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p + row0)[q];
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) v[i] = row0 + i < n ? p[row0 + i] : 0u;
  }
}

// SINGLE: one measure (num) gives sum, min and max, and each active row
// counts 1 (group_aggregate_impl); otherwise four partial columns
// (combine_group_aggregate_impl).
template <bool SINGLE>
__global__ void __launch_bounds__(THREADS, SINGLE ? 3 : 2) run_aggregate_kernel(Args a) {
  extern __shared__ uint32_t s_stage[];  // [4][STAGE]: the groups that end in the tile
  __shared__ Part s_warp[WARPS];  // the warps' totals, then their exclusive prefixes
  __shared__ Part s_prefix;
  __shared__ uint32_t s_tile, s_lo, s_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(a.tile_counter, 1u);
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t tiles = (a.n + TILE - 1) / TILE;
  const int64_t row0 = t * TILE + (int64_t)tid * ITEMS;
  // the rows' flags: bit i for row row0 + i (0 past n)
  uint32_t w[4];
  dbt::load_bytes16(a.active, row0, a.n, w);
  const uint32_t act = dbt::byte_mask16(w);
  dbt::load_bytes16(a.adj, row0, a.n, w);
  const uint32_t start = act & ~dbt::byte_mask16(w);
  // a tile without an active row adds nothing and ends a group at its last
  // row at most: its measures are not read
  const bool live = __syncthreads_or(act != 0u) != 0;
  const bool fast = (t + 1) * TILE <= a.n;
  uint32_t v0[ITEMS], v1[SINGLE ? 1 : ITEMS], v2[SINGLE ? 1 : ITEMS], v3[SINGLE ? 1 : ITEMS];
  Part mine = identity();  // the thread's rows
  if (live) {
    load_rows(a.v[0], row0, a.n, fast && dbt::aligned_to(a.v[0], 16), v0);
    if constexpr (!SINGLE) {
      load_rows(a.v[1], row0, a.n, fast && dbt::aligned_to(a.v[1], 16), v1);
      load_rows(a.v[2], row0, a.n, fast && dbt::aligned_to(a.v[2], 16), v2);
      load_rows(a.v[3], row0, a.n, fast && dbt::aligned_to(a.v[3], 16), v3);
    }
  }
  auto element = [&](int i) -> Part {
    const uint32_t f = (start >> i) & 1u;
    if (!((act >> i) & 1u)) return {f, 0u, 0u, 0xFFFFFFFFu, 0u};
    if constexpr (SINGLE) {
      return {f, 1u, v0[i], v0[i], v0[i]};
    } else {
      return {f, v0[i], v1[i], v2[i], v3[i]};
    }
  };
  if (live) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) mine = combine(mine, element(i));
  }
  // the warp's lanes, then the warps, then the tiles before
  const Part inc = warp_inclusive(mine);
  Part excl = shfl_up(inc, 1);
  if (lane == 0) excl = identity();
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // the warps' prefixes, the tile's aggregate, the look-back
    const Part wt = lane < WARPS ? s_warp[lane] : identity();
    const Part winc = warp_inclusive(wt);
    const Part wex = shfl_up(winc, 1);
    __syncwarp();
    if (lane < WARPS) s_warp[lane] = lane == 0 ? identity() : wex;
    const Part total = shfl(winc, WARPS - 1);
    Part prefix = identity();
    if (t == 0) {
      if (lane == 0) {
        put_part(a.prefix, total);
        st_release(a.state, STATE_PREFIX);
      }
    } else {
      if (lane == 0) {
        put_part(a.agg + t * PART_WORDS, total);
        st_release(a.state + t, STATE_AGGREGATE);
      }
      prefix = lookback(a, t);
      if (lane == 0) {
        put_part(a.prefix + t * PART_WORDS, combine(prefix, total));
        st_release(a.state + t, STATE_PREFIX);
      }
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_lo = 0xFFFFFFFFu;
      s_hi = 0u;
      if (t == tiles - 1) *a.n_groups = (int32_t)(prefix.n + total.n);
    }
  }
  __syncthreads();
  // a row ends its group where the next row starts one or no row follows;
  // the row after the thread's last is the next lane's first, and after
  // the warp's last lane 31 reads it
  uint32_t next = __shfl_down_sync(dbt::FULL_MASK, start, 1) & 1u;
  if (lane == 31) {
    const int64_t r = row0 + ITEMS;
    next = r >= a.n || (a.active[r] && !a.adj[r]);
  }
  const uint32_t ends = (start >> 1) | (next << (ITEMS - 1));
  Part run = combine(combine(s_prefix, s_warp[warp]), excl);
  if (!live) {  // every row adds the identity: only the tile's last row may end a group
    const int64_t last = min((t + 1) * TILE, a.n) - 1;
    if (row0 <= last && last < row0 + ITEMS && run.n > 0u &&
        (((ends >> (last - row0)) & 1u) || last + 1 == a.n)) {
      const uint32_t g = run.n - 1u;
      a.out[0][g] = run.c;
      a.out[1][g] = run.s;
      a.out[2][g] = run.mn;
      a.out[3][g] = run.mx;
    }
    return;
  }
  // the groups that end in the tile have consecutive ids from base at the
  // least (the group open at the tile's start): staged in shared memory,
  // then stored as four coalesced runs
  const uint32_t base = s_prefix.n > 0u ? s_prefix.n - 1u : 0u;
  uint32_t lo = 0xFFFFFFFFu, hi = 0u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    run = combine(run, element(i));
    const int64_t r = row0 + i;
    if (r < a.n && run.n > 0u && (((ends >> i) & 1u) || r + 1 == a.n)) {
      const uint32_t g = run.n - 1u;
      lo = min(lo, g);
      hi = max(hi, g);
      s_stage[g - base] = run.c;
      s_stage[STAGE + g - base] = run.s;
      s_stage[2 * STAGE + g - base] = run.mn;
      s_stage[3 * STAGE + g - base] = run.mx;
    }
  }
  lo = __reduce_min_sync(dbt::FULL_MASK, lo);
  hi = __reduce_max_sync(dbt::FULL_MASK, hi);
  if (lane == 0 && lo <= hi) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  for (int64_t g = (int64_t)s_lo + tid; g <= (int64_t)s_hi; g += THREADS) {
    const int64_t j = g - base;
#pragma unroll
    for (int c = 0; c < 4; ++c) a.out[c][g] = s_stage[c * STAGE + j];
  }
}

// Rows [n_groups, n) of the four columns get the identities.
__global__ void __launch_bounds__(THREADS)
    identity_tail(uint32_t* out, const int32_t* __restrict__ n_groups, int64_t n) {
  const int64_t g = *n_groups;
  const int64_t r0 = (int64_t)blockIdx.x * THREADS * TAIL_ROWS;
  if (r0 + THREADS * TAIL_ROWS <= g) return;
#pragma unroll
  for (int j = 0; j < TAIL_ROWS; ++j) {
    const int64_t r = r0 + j * THREADS + threadIdx.x;
    if (r >= g && r < n) {
      out[r] = 0u;
      out[n + r] = 0u;
      out[2 * n + r] = 0xFFFFFFFFu;
      out[3 * n + r] = 0u;
    }
  }
}

inline int64_t tiles_of(int64_t n) { return (n + TILE - 1) / TILE; }

}  // namespace

// The scratch in 32-bit words (kernels/run_aggregate.py agg_scratch_words):
// the tile counter and a state word a tile (the memset's bytes), padded to
// 32 bytes, then two payloads of PART_WORDS a tile.
DBT_API int64_t dbt_run_aggregate_scratch_words(int64_t n) {
  const int64_t t = tiles_of(n);
  return (1 + t + 7) / 8 * 8 + 2 * PART_WORDS * t;
}

// active, adj u8[n]; vals: nvals (1 or 4) device pointers to u32 columns of
// n rows; out: [4, n] u32, group-major count, sum, min, max; n_groups: one
// i32 on the device; scratch: dbt_run_aggregate_scratch_words(n) words,
// 4-byte aligned.  One memset of the counter and the state words, then the
// two launches (with n = 0 a memset of n_groups alone).
DBT_API int dbt_run_aggregate(const void* active, const void* adj, const void* const* vals,
                              int nvals, int64_t n, void* out, void* n_groups, void* scratch,
                              int64_t scratch_words, void* stream) {
  if ((nvals != 1 && nvals != 4) || n < 0 || n > dbt::SCAN_MAX_ROWS ||
      scratch_words < dbt_run_aggregate_scratch_words(n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return (int)cudaMemsetAsync(n_groups, 0, sizeof(int32_t), st);
  const int64_t tiles = tiles_of(n);
  uint32_t* w = static_cast<uint32_t*>(scratch);
  const int64_t head = (1 + tiles + 7) / 8 * 8;
  cudaError_t err = cudaMemsetAsync(w, 0, (size_t)(1 + tiles) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.active = static_cast<const uint8_t*>(active);
  a.adj = static_cast<const uint8_t*>(adj);
  uint32_t* o = static_cast<uint32_t*>(out);
  for (int k = 0; k < 4; ++k) {
    a.v[k] = static_cast<const uint32_t*>(vals[k < nvals ? k : 0]);
    a.out[k] = o + k * n;
  }
  a.n_groups = static_cast<int32_t*>(n_groups);
  a.tile_counter = w;
  a.state = w + 1;
  a.agg = w + head;
  a.prefix = w + head + PART_WORDS * tiles;
  a.n = n;
  auto kernel = nvals == 1 ? run_aggregate_kernel<true> : run_aggregate_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)tiles, THREADS, STAGE_BYTES, st>>>(a);
  DBT_CHECK_LAUNCH();
  identity_tail<<<dbt::blocks_for(n, (int64_t)THREADS * TAIL_ROWS), THREADS, 0, st>>>(
      o, static_cast<const int32_t*>(n_groups), n);
  DBT_CHECK_LAUNCH();
  return 0;
}
