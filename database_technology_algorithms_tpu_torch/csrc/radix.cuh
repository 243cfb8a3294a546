// The one-sweep LSD radix sort shared by the view sort K1 (radix_sort.cu)
// and the multi-word sort K5 (words_sort.cu), after Onesweep (Adinets and
// Merrill, 2022).
//
// It replaces a pass of five launches (a histogram, the three-phase scan of
// scan.cuh over 256 x tiles counts, a scatter that walked its tile 256 rows
// at a time behind three barriers and stored every row straight to its
// digit run, one useful 4-byte word in most 32-byte sectors).
//
// What it sorts: the row index, stably, by digits of u32 key columns, least
// significant digit first.  The schedule comes from the host (the wrappers
// build it, kernels/radix_plan.py): one (word, shift, flag) triple a pass,
// digit = (words[word] >> shift) & 0xFF, with the row's inactive flag as a
// ninth, most significant bit (512 buckets) where flag is 1, which only the
// last pass may be.  A word's passes are consecutive in the schedule.
//
//   onesweep_hist  one launch before the passes.  It reads each key column
//                  and the inactive flags once, in row order, and counts the
//                  digits of every pass: an LSD pass's global counts do not
//                  depend on the order the earlier passes left.  Counts go to
//                  shared memory and then global atomics; a warp whose live
//                  lanes share one digit adds them with one atomic, so a
//                  constant digit costs one atomic a warp, not one a row.
//                  The last block to finish scans the counts to each pass's
//                  digit offsets and routes the passes (rs_route, below).
//   onesweep_pass  one launch a pass, one tile of RS_TILE rows a block.  The
//                  block reads the pass's route and digit offsets and takes
//                  its tile from an atomic counter, not from blockIdx, so a
//                  block that spins in the look-back waits only on blocks
//                  that started before it.  It loads the tile warp-striped
//                  into registers, ranks it stably (the peers of a digit
//                  within a warp by one ballot a digit bit, counts per warp in
//                  shared memory, a prefix over the warps), publishes its
//                  per-digit counts in status words (one word a tile and
//                  digit: 0 before it is published, then the tile's count
//                  plus one, then the inclusive prefix with bit 31 set, so
//                  that one flag bit leaves 31 bits for the prefix), reorders
//                  the tile by digit in shared memory, looks back over
//                  earlier tiles for its exclusive per-digit offset
//                  (decoupled look-back, RS_LOOKBACK tiles a load round) and
//                  writes each digit run with consecutive threads on
//                  consecutive addresses.
// A pass whose digit is the same for every row (one bucket of the histogram
// holds all n rows: NUL bytes of short strings, the high byte of small
// numbers, the flag when every row is active) would leave the order as it
// is, so it moves nothing: its blocks return at once.  The choice is made on
// the card, with no host synchronization: the histogram's last block writes
// each pass's route (skip, or scatter with its buffers), the passes that
// scatter take the two buffers in turn and the last of them writes the
// outputs; where every pass is trivial the last pass copies the input
// through to the outputs.  Skipping rather than copying saves 16 B a row for
// every such pass (three of K5's eight on 5-letter strings, K1's top pass on
// the main path) for one word of routing a pass.
//
// The value that moves is the row index with the row's inactive flag in bit
// 31 (n < 2^31), made by the first pass that scatters; the last writes perm
// = val & 0x7FFFFFFF and act = !flag.  The first pass of a word to scatter
// reads the word through the order so far, words[w][val * stride] (strided
// columns of a row-major matrix are read where they lie; in row order when
// no pass scattered before it); the word then moves with the value through
// its other passes, so a sort over m words makes at most m - 1 random reads
// a row, not one a pass.
//
// Bound: bytes.  A scatter pass reads and writes 8 B a row (key and value),
// 4 B where the key is not carried on.  Choices: 8-bit digits (256 buckets)
// because the 33-bit (flag, key) composite then takes four passes, the top
// one 9 bits wide; 512 threads x 8 rows a tile, so that the tile's keys and
// values (32 KB) reorder in shared memory and 2M rows make 489 tiles, above
// the resident block count; the per-warp counters share that space, being
// dead before the reorder.  A pass is bound by its tiles' latency more than
// by its bytes, so the shape is the one that keeps the most warps resident:
// 512 x 8 (about 60 registers, 32 warps an SM) ran faster on the card than
// 256 x 16 (over 100 registers, 16 warps) and 256 x 8 (smaller tiles, more
// of them to look back over).  The first npasses words of the scratch hold
// each pass's kind (trivial or scattered) afterwards, for the caller that
// records them.
#pragma once

#include "common.cuh"

namespace dbt {

constexpr int RS_THREADS = 512;
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int RS_ITEMS = 8;
constexpr int RS_TILE = RS_THREADS * RS_ITEMS;
constexpr int RS_BUCKETS = 512;  // the most a pass has: 8 key bits and the flag
constexpr int RS_WORD_PASSES = 4;  // 8-bit digits of a u32 word
constexpr int RS_MAX_PASSES = RS_WORD_PASSES * MAX_KEY_WORDS;
// the row index is 31 bits of the value (bit 31 is the flag), and a status
// word's prefix 31 bits
constexpr int64_t RS_MAX_ROWS = 0x7FFFFFFF;
// A status word (one a tile and digit): 0 until the tile publishes; then its
// aggregate, the tile's count of the digit plus one (at most RS_TILE + 1);
// then its inclusive prefix over tiles 0..t, RS_PREFIX | prefix (prefix <= n).
constexpr uint32_t RS_PREFIX = 0x80000000u;
constexpr uint32_t RS_COUNT_MASK = 0x7FFFFFFFu;
constexpr uint32_t RS_FLAG_BIT = 0x80000000u;  // the value's inactive flag
constexpr int RS_HIST_BLOCKS = 256;  // blocks of the histogram at most
// copies of the global histogram, block b adding into copy b % RS_HIST_COPIES,
// so that fewer blocks queue on each counter's atomics
constexpr int RS_HIST_COPIES = 8;
constexpr int RS_HIST_UNROLL = 8;  // rows a thread loads before it counts them
constexpr int RS_LOOKBACK = 16;    // predecessor tiles read at once
enum : uint32_t { RS_KIND_TRIVIAL = 1u, RS_KIND_SCATTERED = 2u };
// A pass's route (rs_route); bits 8 and up count the passes that scatter before it.
enum : uint32_t {
  RS_ROUTE_SCATTER = 1u,   // rank and scatter (else, without COPY, nothing)
  RS_ROUTE_COPY = 2u,      // copy the input through (every pass trivial)
  RS_ROUTE_CARRIED = 4u,   // the key comes from the pass before, same word
  RS_ROUTE_GATHER = 8u,    // the key is read through the row index
  RS_ROUTE_VALS = 16u,     // the row values come from the pass before
  RS_ROUTE_KEYS = 32u,     // the key is written on
  RS_ROUTE_LAST = 64u,     // writes the outputs
  RS_ROUTE_NEXT = 128u,    // another pass scatters after this one
};

// The schedule as the kernels read it (by value, as a launch argument).
struct RadixPlan {
  int npasses;
  int8_t word[RS_MAX_PASSES];
  int8_t shift[RS_MAX_PASSES];
  int8_t flag[RS_MAX_PASSES];
  int16_t first[MAX_KEY_WORDS];  // a word's first pass
  int8_t count[MAX_KEY_WORDS];   // and its number of passes
};

// What a sort reads and writes.  keys_out (the last pass's word in sorted
// order) and act_out may be null; act_out needs inact.
struct RadixIO {
  KeyCols cols;
  const uint8_t* inact;
  uint32_t* keys_out;
  int32_t* perm_out;
  uint8_t* act_out;
};

// sched: npasses (word, shift, flag) triples on the host.
inline int radix_plan(const int32_t* sched, int npasses, int nwords, bool has_inact,
                      RadixPlan* plan) {
  if (npasses < 1 || npasses > RS_MAX_PASSES || nwords < 1 || nwords > MAX_KEY_WORDS)
    return (int)cudaErrorInvalidValue;
  plan->npasses = npasses;
  for (int w = 0; w < MAX_KEY_WORDS; ++w) {
    plan->first[w] = -1;
    plan->count[w] = 0;
  }
  for (int p = 0; p < npasses; ++p) {
    const int w = sched[3 * p], shift = sched[3 * p + 1], flag = sched[3 * p + 2];
    if (w < 0 || w >= nwords || shift < 0 || shift > 24 || (flag != 0 && flag != 1))
      return (int)cudaErrorInvalidValue;
    if (flag && p != npasses - 1) return (int)cudaErrorInvalidValue;
    if (plan->count[w] == 0) {
      plan->first[w] = (int16_t)p;
    } else if (sched[3 * (p - 1)] != w || plan->count[w] == RS_WORD_PASSES) {
      return (int)cudaErrorInvalidValue;  // a word's passes are consecutive, four at most
    }
    ++plan->count[w];
    plan->word[p] = (int8_t)w;
    plan->shift[p] = (int8_t)shift;
    plan->flag[p] = (int8_t)flag;
  }
  if ((plan->flag[npasses - 1] != 0) != has_inact) return (int)cudaErrorInvalidValue;
  return 0;
}

template <int NB>
__device__ __forceinline__ uint32_t rs_digit(uint32_t key, uint32_t val, int shift) {
  uint32_t d = (key >> shift) & 0xFFu;
  if constexpr (NB == 512) d |= (val >> 31) << 8;
  return d;
}

// Status words are published with a release store and read with relaxed
// loads at device scope: the count travels in the same word as its flag, and
// nothing else is read on the strength of it, so the loads need no order
// among themselves and a window of them is in flight at once.
__device__ __forceinline__ void rs_publish(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t rs_peek(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Decoupled look-back for digit d of tile t: the sum of the digit's counts
// over tiles 0..t-1.  It reads RS_LOOKBACK predecessors at once, adds the
// aggregates from the nearest one back until an inclusive prefix, and polls
// again from the first one that has not published yet: the tiles of a wave
// publish their aggregates together, and one load a tile would wait a load's
// latency for each of them.
__device__ __forceinline__ uint32_t rs_lookback(const uint32_t* status, int64_t t, int d) {
  uint32_t excl = 0;
  int64_t u = t - 1;
  while (true) {
    uint32_t sw[RS_LOOKBACK];
#pragma unroll
    for (int w = 0; w < RS_LOOKBACK; ++w)
      sw[w] = u - w >= 0 ? rs_peek(&status[(u - w) * RS_BUCKETS + d]) : 0u;
    int used = 0;
    bool done = false;
#pragma unroll
    for (int w = 0; w < RS_LOOKBACK; ++w) {
      if (!done && used == w && sw[w] != 0u) {
        excl += sw[w] & RS_COUNT_MASK;
        used = w + 1;
        done = (sw[w] & RS_PREFIX) != 0u;
      }
    }
    excl -= (uint32_t)(used - (int)done);  // each aggregate is its count plus one
    if (done) return excl;
    u -= used;
  }
}

// The lanes of the warp whose digit equals this lane's, among `live`: one
// ballot a digit bit.  Every lane of the warp calls it.  It ranked faster on
// the card than the hardware's __match_any_sync.
template <int BITS>
__device__ __forceinline__ unsigned rs_match(uint32_t d, unsigned live) {
  unsigned peers = live;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned ones = __ballot_sync(FULL_MASK, (d >> b) & 1u);
    peers &= (d >> b) & 1u ? ones : ~ones;
  }
  return peers;
}

// Exclusive scan of one u32 a thread across the block; *total gets the sum.
// Every thread of the block must call it.
__device__ __forceinline__ uint32_t rs_block_exclusive(uint32_t x, uint32_t* s_warp,
                                                       uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL_MASK, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  uint32_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < RS_WARPS; ++w) {
    const uint32_t c = s_warp[w];
    before += w < warp ? c : 0u;
    sum += c;
  }
  *total = sum;
  __syncthreads();  // s_warp is reused by the next call
  return before + inc - x;
}

// Routes each pass from the triviality of all passes, on one thread: a pass
// that is trivial does nothing; the others scatter, counted k = 0, 1, ... in
// order, executed pass k reading buffer (k - 1) & 1 and writing k & 1, its
// key from the column (k = 0: in row order; else through the row index) or
// carried on from the pass before when that was of the same word; the last
// that scatters writes the outputs.  When every pass is trivial the last one
// copies the input through to the outputs.
static __device__ void rs_route(const RadixPlan& plan, const uint8_t* trivial, bool keys_out,
                                uint32_t* routes, uint32_t* kinds) {
  const int np = plan.npasses;
  int last = -1;
  for (int p = 0; p < np; ++p)
    if (!trivial[p]) last = p;
  const bool none = last < 0;
  if (none) last = np - 1;
  int k = 0, prev_word = -1;
  for (int p = 0; p < np; ++p) {
    kinds[p] = trivial[p] ? RS_KIND_TRIVIAL : RS_KIND_SCATTERED;
    if (none ? p != last : trivial[p]) {
      routes[p] = 0u;
      continue;
    }
    const int w = plan.word[p];
    uint32_t r = trivial[p] ? RS_ROUTE_COPY : RS_ROUTE_SCATTER;
    if (prev_word == w) r |= RS_ROUTE_CARRIED;
    else if (k > 0) r |= RS_ROUTE_GATHER;
    if (k > 0) r |= RS_ROUTE_VALS;
    if (p == last) {
      r |= RS_ROUTE_LAST | (keys_out ? RS_ROUTE_KEYS : 0u);
    } else {
      int q = p + 1;
      while (trivial[q]) ++q;  // the next pass that scatters
      r |= RS_ROUTE_NEXT | (plan.word[q] == w ? RS_ROUTE_KEYS : 0u);
    }
    routes[p] = r | (uint32_t)k << 8;
    prev_word = w;
    ++k;
  }
}

// Adds one warp's digits to a shared histogram: where the 32 live lanes
// share one digit (a constant digit, a run of equal keys) one lane adds them
// all; else each lane adds its own.
__device__ __forceinline__ void rs_count(uint32_t* s_hist, uint32_t d, unsigned live) {
  const uint32_t d0 = __shfl_sync(FULL_MASK, d, 0);
  if (__all_sync(FULL_MASK, d == d0 || !((live >> (threadIdx.x & 31)) & 1u))) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&s_hist[d0], (uint32_t)__popc(live));
  } else if ((live >> (threadIdx.x & 31)) & 1u) {
    atomicAdd(&s_hist[d], 1u);
  }
}

// hist[copy][p * RS_BUCKETS + d] += the rows whose digit of pass p is d, for
// the passes of word blockIdx.y, over the rows [blockIdx.x * chunk, + chunk).
// The last block to finish routes the passes (rs_route) and writes every
// pass's exclusive digit offsets, the sum of the copies scanned, into copy 0.
static __global__ void __launch_bounds__(RS_THREADS)
onesweep_hist(KeyCols cols, const uint8_t* inact, int64_t n, RadixPlan plan, uint32_t* hist,
              int64_t chunk, uint32_t* done, uint32_t* routes, uint32_t* kinds, bool keys_out) {
  __shared__ uint32_t s_hist[RS_WORD_PASSES * RS_BUCKETS];
  __shared__ uint8_t s_trivial[RS_MAX_PASSES];
  __shared__ uint32_t s_warp[RS_WARPS];
  __shared__ bool s_last;
  const int w = blockIdx.y;
  const int np = plan.count[w];
  const int p0 = plan.first[w];
  if (np > 0) {
    for (int j = threadIdx.x; j < np * RS_BUCKETS; j += RS_THREADS) s_hist[j] = 0u;
    __syncthreads();
    int shift[RS_WORD_PASSES];
    bool flag[RS_WORD_PASSES];
    bool any_flag = false;
#pragma unroll
    for (int lp = 0; lp < RS_WORD_PASSES; ++lp) {
      shift[lp] = lp < np ? plan.shift[p0 + lp] : 0;
      flag[lp] = lp < np && plan.flag[p0 + lp];
      any_flag |= flag[lp];
    }
    const uint32_t* col = cols.ptr[w];
    const int64_t stride = cols.stride[w];
    const int64_t lo = (int64_t)blockIdx.x * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    // every thread runs the same number of rounds (the warp votes together)
    for (int64_t r0 = lo; r0 < hi; r0 += RS_HIST_UNROLL * RS_THREADS) {
      uint32_t key[RS_HIST_UNROLL], f[RS_HIST_UNROLL];
#pragma unroll
      for (int u = 0; u < RS_HIST_UNROLL; ++u) {
        const int64_t i = r0 + u * RS_THREADS + threadIdx.x;
        key[u] = i < hi ? col[i * stride] : 0u;
        f[u] = any_flag && i < hi && inact[i] ? 1u : 0u;
      }
#pragma unroll
      for (int u = 0; u < RS_HIST_UNROLL; ++u) {
        const unsigned live = __ballot_sync(FULL_MASK, r0 + u * RS_THREADS + threadIdx.x < hi);
        if (live == 0u) break;  // the same for the whole warp
#pragma unroll
        for (int lp = 0; lp < RS_WORD_PASSES; ++lp)
          if (lp < np)
            rs_count(s_hist + lp * RS_BUCKETS,
                     ((key[u] >> shift[lp]) & 0xFFu) | (flag[lp] ? f[u] << 8 : 0u), live);
      }
    }
    __syncthreads();
    uint32_t* copy = hist + (int64_t)(blockIdx.x % RS_HIST_COPIES) * plan.npasses * RS_BUCKETS;
    for (int j = threadIdx.x; j < np * RS_BUCKETS; j += RS_THREADS) {
      const uint32_t c = s_hist[j];
      if (c) atomicAdd(&copy[(int64_t)p0 * RS_BUCKETS + j], c);
    }
  }
  // the last block to finish reads every pass's counts
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  constexpr int DPT = RS_BUCKETS / RS_THREADS;
  for (int p = 0; p < plan.npasses; ++p) {
    uint32_t* h = hist + (int64_t)p * RS_BUCKETS;
    uint32_t c[DPT], sum = 0, total;
    bool whole = false;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      c[j] = 0u;
      for (int k = 0; k < RS_HIST_COPIES; ++k)
        c[j] += __ldcg(&h[(int64_t)k * plan.npasses * RS_BUCKETS + threadIdx.x * DPT + j]);
      sum += c[j];
      whole |= c[j] == (uint32_t)n;
    }
    uint32_t run = rs_block_exclusive(sum, s_warp, &total);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      h[threadIdx.x * DPT + j] = run;
      run += c[j];
    }
    whole = __syncthreads_or(whole);
    if (threadIdx.x == 0) s_trivial[p] = whole;
  }
  if (threadIdx.x == 0) rs_route(plan, s_trivial, keys_out, routes, kinds);
}

struct PassArgs {
  const uint32_t* col;     // the pass's key column
  int64_t stride;          // its row stride (words)
  uint32_t* kbuf[2];       // keys carried from pass to pass
  int32_t* vbuf[2];        // the row values (index, flag in bit 31)
  const uint8_t* inact;    // read where the values start; may be null
  const uint32_t* offsets; // this pass's exclusive digit offsets
  uint32_t* status[2];     // look-back words [tiles][RS_BUCKETS], by k & 1
  uint32_t* tile_counter;
  const uint32_t* route;   // this pass's route (rs_route)
  uint32_t* keys_out;      // the outputs, written by the last pass that moves rows
  int32_t* perm_out;
  uint8_t* act_out;
  int shift;
  int64_t n;
};

// Where one pass reads and writes, from its route.
struct PassIO {
  const uint32_t* kin;  // carried keys, or the column
  int64_t stride;
  bool gather;          // read the column through the row index
  const int32_t* vin;   // null: the row index, with inact[i] in bit 31
  uint32_t* kout;       // null where the key is not carried on
  int32_t* vout;
  uint8_t* act;
  bool last;
};

__device__ __forceinline__ PassIO rs_io(const PassArgs& a, uint32_t r) {
  const int k = (int)(r >> 8);
  PassIO io;
  const bool carried = (r & RS_ROUTE_CARRIED) != 0u;
  io.kin = carried ? a.kbuf[(k - 1) & 1] : a.col;
  io.stride = carried ? 1 : a.stride;
  io.gather = (r & RS_ROUTE_GATHER) != 0u;
  io.vin = (r & RS_ROUTE_VALS) ? a.vbuf[(k - 1) & 1] : nullptr;
  io.last = (r & RS_ROUTE_LAST) != 0u;
  io.kout = (r & RS_ROUTE_KEYS) ? (io.last ? a.keys_out : a.kbuf[k & 1]) : nullptr;
  io.vout = io.last ? a.perm_out : a.vbuf[k & 1];
  io.act = io.last ? a.act_out : nullptr;
  return io;
}

// Row base + k * 32 + lane for k < RS_ITEMS: a warp reads 32 consecutive rows
// at a time.
__device__ __forceinline__ void rs_load(const PassArgs& a, const PassIO& io, int64_t base,
                                        uint32_t (&key)[RS_ITEMS], uint32_t (&val)[RS_ITEMS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < RS_ITEMS; ++k) {
    const int64_t i = base + k * 32 + lane;
    if (i < a.n) {
      const uint32_t v = io.vin ? (uint32_t)io.vin[i]
                                : (uint32_t)i | (a.inact && a.inact[i] ? RS_FLAG_BIT : 0u);
      val[k] = v;
      key[k] = io.kin[(io.gather ? (int64_t)(v & ~RS_FLAG_BIT) : i) * io.stride];
    }
  }
}

__device__ __forceinline__ void rs_store(const PassIO& io, int64_t g, uint32_t key, uint32_t val) {
  if (io.kout) io.kout[g] = key;
  if (io.last) {
    io.vout[g] = (int32_t)(val & ~RS_FLAG_BIT);
    if (io.act) io.act[g] = (val & RS_FLAG_BIT) == 0u;
  } else {
    io.vout[g] = (int32_t)val;
  }
}

template <int NB>
__global__ void __launch_bounds__(RS_THREADS) onesweep_pass(PassArgs a) {
  // digits a thread owns: tid * DPT + j, those below NB (with more threads
  // than digits, threads tid < NB own one each)
  constexpr int DPT = NB > RS_THREADS ? NB / RS_THREADS : 1;
  __shared__ union {
    uint32_t whist[RS_WARPS][NB];  // per-warp digit counts, then their prefixes
    struct {
      uint32_t key[RS_TILE];
      uint32_t val[RS_TILE];
    } tile;  // the tile in digit order
  } s;
  __shared__ uint32_t s_local[NB];  // a digit's first slot in the tile
  __shared__ uint32_t s_base[NB];   // output row of slot 0 of a digit's run
  __shared__ uint32_t s_warp[RS_WARPS];
  __shared__ uint32_t s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the tile index, the route and the digit offsets are fetched at once
  if (tid == 0) s_tile = atomicAdd(a.tile_counter, 1u);
  const uint32_t r = *a.route;
  if ((r & (RS_ROUTE_SCATTER | RS_ROUTE_COPY)) == 0u) return;  // trivial: nothing moves
  const PassIO io = rs_io(a, r);
  const int k_exec = (int)(r >> 8);
  uint32_t* status = a.status[k_exec & 1];
  uint32_t* status_next = (r & RS_ROUTE_NEXT) ? a.status[(k_exec + 1) & 1] : nullptr;
  uint32_t key[RS_ITEMS], val[RS_ITEMS];

  if (r & RS_ROUTE_COPY) {  // every pass trivial: the input goes through as it is
    const int64_t base = (int64_t)blockIdx.x * RS_TILE + warp * 32 * RS_ITEMS;
    rs_load(a, io, base, key, val);
#pragma unroll
    for (int k = 0; k < RS_ITEMS; ++k) {
      const int64_t i = base + k * 32 + lane;
      if (i < a.n) rs_store(io, i, key[k], val[k]);
    }
    return;
  }

  uint32_t goff[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) goff[j] = tid * DPT + j < NB ? a.offsets[tid * DPT + j] : 0u;
  for (int j = tid; j < RS_WARPS * NB; j += RS_THREADS) (&s.whist[0][0])[j] = 0u;
  __syncthreads();
  const int64_t t = s_tile;
  if (status_next)
    for (int j = tid; j < RS_BUCKETS; j += RS_THREADS) status_next[t * RS_BUCKETS + j] = 0u;
  const int64_t tile0 = t * RS_TILE;
  const int64_t base = tile0 + warp * 32 * RS_ITEMS;
  rs_load(a, io, base, key, val);

  // stable rank within the warp's 32 x RS_ITEMS rows: item-major, lane-minor is
  // row order
  uint32_t slot[RS_ITEMS];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < RS_ITEMS; ++k) {
    const bool live = base + k * 32 + lane < a.n;
    const unsigned mask = __ballot_sync(FULL_MASK, live);
    const uint32_t d = live ? rs_digit<NB>(key[k], val[k], a.shift) : 0u;
    const unsigned peers = rs_match<NB == 512 ? 9 : 8>(d, mask);
    uint32_t before = 0;
    if (live) {
      before = s.whist[warp][d];
      slot[k] = before + __popc(peers & below);
    }
    __syncwarp();
    if (live && (peers & below) == 0u) s.whist[warp][d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per digit: the warps' counts become their exclusive prefixes; the tile's
  // count is published at once
  uint32_t cnt[DPT];
  uint32_t* st = status + t * RS_BUCKETS;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = tid * DPT + j;
    uint32_t run = 0;
    if (d < NB) {
#pragma unroll
      for (int w = 0; w < RS_WARPS; ++w) {
        const uint32_t x = s.whist[w][d];
        s.whist[w][d] = run;
        run += x;
      }
      rs_publish(&st[d], t == 0 ? RS_PREFIX | run : run + 1u);
    }
    cnt[j] = run;
  }
  uint32_t local[DPT];
  {
    uint32_t sum = 0, total;
#pragma unroll
    for (int j = 0; j < DPT; ++j) sum += cnt[j];
    uint32_t run = rs_block_exclusive(sum, s_warp, &total);
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      local[j] = run;
      if (tid * DPT + j < NB) s_local[tid * DPT + j] = run;
      run += cnt[j];
    }
  }
  __syncthreads();

  // the tile in digit order, in shared memory; it needs no global offset, so
  // it comes before the look-back and the predecessors publish meanwhile
#pragma unroll
  for (int k = 0; k < RS_ITEMS; ++k) {
    if (base + k * 32 + lane < a.n) {
      const uint32_t d = rs_digit<NB>(key[k], val[k], a.shift);
      slot[k] += s_local[d] + s.whist[warp][d];
    }
  }
  __syncthreads();  // the counters' space becomes the tile
#pragma unroll
  for (int k = 0; k < RS_ITEMS; ++k) {
    if (base + k * 32 + lane < a.n) {
      s.tile.key[slot[k]] = key[k];
      s.tile.val[slot[k]] = val[k];
    }
  }

  // decoupled look-back: the digit's rows in earlier tiles
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = tid * DPT + j;
    if (d >= NB) break;
    uint32_t excl = 0;
    if (t > 0) {
      excl = rs_lookback(status, t, d);
      rs_publish(&st[d], RS_PREFIX | (excl + cnt[j]));
    }
    s_base[d] = goff[j] + excl - local[j];  // mod 2^32; slot >= local[j] brings it back
  }
  __syncthreads();
  const int64_t left = a.n - tile0;
  const int tile_n = left < RS_TILE ? (int)left : RS_TILE;
#pragma unroll
  for (int k = 0; k < RS_ITEMS; ++k) {
    const int j = k * RS_THREADS + tid;
    if (j < tile_n) {
      const uint32_t kk = s.tile.key[j];
      const uint32_t vv = s.tile.val[j];
      const uint32_t d = rs_digit<NB>(kk, vv, a.shift);
      rs_store(io, (int64_t)(uint32_t)(s_base[d] + (uint32_t)j), kk, vv);
    }
  }
}

inline int64_t radix_tiles(int64_t n) { return (n + RS_TILE - 1) / RS_TILE; }

// kinds[np] | routes[np] | tile counters[np] | done
// | hist[RS_HIST_COPIES][np][RS_BUCKETS] | status[2][tiles][RS_BUCKETS]
// | keys[2][n] | vals[2][n] | 4 words of slack; everything up to status[1]
// is zeroed by one memset, status[1] by the first pass that scatters.  After
// the last pass the keys and vals (4n words) are free: the gather of the
// extra words packs its rows there, 16-byte aligned (the slack).
inline int64_t radix_scratch_words(int64_t n, int npasses) {
  return 3 * (int64_t)npasses + 1 + (int64_t)RS_HIST_COPIES * npasses * RS_BUCKETS +
         2 * radix_tiles(n) * RS_BUCKETS + 4 * n + 4;
}

// The key and value buffers of the scratch (4n words and the slack), free
// once the last pass has written the outputs.
inline uint32_t* radix_key_buffers(uint32_t* scratch, int64_t n, int npasses) {
  return scratch + 3 * (int64_t)npasses + 1 + (int64_t)RS_HIST_COPIES * npasses * RS_BUCKETS +
         2 * radix_tiles(n) * RS_BUCKETS;
}

// The whole sort: a memset, the histogram, one launch a pass.  The first
// npasses words of scratch hold the kinds of the passes afterwards
// (RS_KIND_TRIVIAL or RS_KIND_SCATTERED).
inline int radix_sort(const RadixIO& io, const int32_t* sched, int npasses, int64_t n,
                      uint32_t* scratch, cudaStream_t st) {
  if (n <= 0) return 0;
  if (n > RS_MAX_ROWS) return (int)cudaErrorInvalidValue;
  RadixPlan plan;
  int err = radix_plan(sched, npasses, io.cols.count, io.inact != nullptr, &plan);
  if (err) return err;
  if ((io.act_out && !io.inact) || (io.keys_out && io.cols.count != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = radix_tiles(n);
  uint32_t* kinds = scratch;
  uint32_t* routes = kinds + npasses;
  uint32_t* counters = routes + npasses;
  uint32_t* done = counters + npasses;
  uint32_t* hist = done + 1;
  uint32_t* status0 = hist + (int64_t)RS_HIST_COPIES * npasses * RS_BUCKETS;
  uint32_t* status1 = status0 + tiles * RS_BUCKETS;
  uint32_t* kb0 = status1 + tiles * RS_BUCKETS;
  cudaError_t ce = cudaMemsetAsync(scratch, 0, (size_t)(status1 - scratch) * sizeof(uint32_t), st);
  if (ce != cudaSuccess) return (int)ce;

  const int64_t hblocks = tiles < RS_HIST_BLOCKS ? tiles : RS_HIST_BLOCKS;
  const int64_t chunk = ((n + hblocks - 1) / hblocks + RS_THREADS - 1) / RS_THREADS * RS_THREADS;
  onesweep_hist<<<dim3((unsigned)hblocks, (unsigned)io.cols.count), RS_THREADS, 0, st>>>(
      io.cols, io.inact, n, plan, hist, chunk, done, routes, kinds, io.keys_out != nullptr);
  DBT_CHECK_LAUNCH();

  PassArgs a;
  a.kbuf[0] = kb0;
  a.kbuf[1] = kb0 + n;
  a.vbuf[0] = reinterpret_cast<int32_t*>(kb0 + 2 * n);
  a.vbuf[1] = reinterpret_cast<int32_t*>(kb0 + 3 * n);
  a.inact = io.inact;
  a.status[0] = status0;
  a.status[1] = status1;
  a.keys_out = io.keys_out;
  a.perm_out = io.perm_out;
  a.act_out = io.act_out;
  a.n = n;
  for (int p = 0; p < npasses; ++p) {
    const int w = plan.word[p];
    a.col = io.cols.ptr[w];
    a.stride = io.cols.stride[w];
    a.offsets = hist + (int64_t)p * RS_BUCKETS;
    a.tile_counter = counters + p;
    a.route = routes + p;
    a.shift = plan.shift[p];
    if (plan.flag[p]) onesweep_pass<512><<<(unsigned)tiles, RS_THREADS, 0, st>>>(a);
    else onesweep_pass<256><<<(unsigned)tiles, RS_THREADS, 0, st>>>(a);
    DBT_CHECK_LAUNCH();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The gather of the extra words: extra_out[j][i] = extra_in[j][perm[i]].
//
// Bound on the H100: bytes (the order read, each extra word read and written
// once).  The order is a sort's permutation, so the reads are random: a
// 4-byte read of a word costs a 32-byte sector, and one word after another
// costs a sector each.  Two forms, chosen by the host's plan
// (kernels/radix_plan.gather_packed) from the words and the rows:
//
//   packed  a coalesced pass interleaves a group of 2-4 words into rows of
//           8 or 16 bytes (a group of 3 is padded to 4) in the sort's free
//           key buffers, then each row moves by one 8- or 16-byte load: one
//           sector a row, whatever its words.  More than 4 words go as
//           groups of 4 (a last group of one word goes direct).  Measured
//           on the H100, it pays from about 1M rows of 2 words (the pack
//           pass costs what it saves below): 0.63 ms against 0.97 at 16M
//           rows, where the packed gather runs at the device memory's rate
//           of random sectors (tools/gather_sweep.py).
//   direct  up to MAX_WORDS words a launch, one 4-byte load a word.
//
// In both a thread takes GW_ROWS = 4 rows: its 4 entries of the order by
// one 16-byte load, then every load of its rows before any store, then each
// word's 4 outputs as one 16-byte store, consecutive threads on consecutive
// rows (coalesced, column by column).  A thread whose rows pass n takes them
// one by one.  The order and the outputs must be 16-byte aligned (the
// wrappers allocate them); the sources and the count n may be anything.
// 1, 2, 4 and 8 rows a thread measured within 1% of each other on the H100
// (16M rows of 2-9 words), so the rows are a constant.
constexpr int GW_THREADS = 256;
constexpr int GW_ROWS = 4;
constexpr int GW_PACK_WORDS = 4;  // words of a packed row at most (16 bytes)

template <int G>
struct GwVec;
template <>
struct GwVec<2> {
  using T = uint2;
  static __device__ __forceinline__ void put(uint32_t* d, T v) { d[0] = v.x; d[1] = v.y; }
  static __device__ __forceinline__ T make(const uint32_t* s) { return make_uint2(s[0], s[1]); }
};
template <>
struct GwVec<4> {
  using T = uint4;
  static __device__ __forceinline__ void put(uint32_t* d, T v) {
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  static __device__ __forceinline__ T make(const uint32_t* s) {
    return make_uint4(s[0], s[1], s[2], s[3]);
  }
};

// GW_ROWS consecutive u32 words at p (16-byte aligned when whole).
__device__ __forceinline__ void gw_load_run(const uint32_t* p, bool whole, int64_t left,
                                            uint32_t (&v)[GW_ROWS]) {
  if (whole) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    return;
  }
#pragma unroll
  for (int r = 0; r < GW_ROWS; ++r) v[r] = r < left ? __ldg(p + r) : 0u;
}

__device__ __forceinline__ void gw_store_run(uint32_t* p, bool whole, int64_t left,
                                             const uint32_t (&v)[GW_ROWS]) {
  if (whole) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int r = 0; r < GW_ROWS; ++r)
    if (r < left) p[r] = v[r];
}

// packed[i * G + k] = src[k][i] for k < count, 0 for the pad words.
template <int G>
static __global__ void __launch_bounds__(GW_THREADS)
    gather_words_pack(int64_t n, WordPtrs w, uint32_t* packed) {
  const int64_t i = (int64_t)blockIdx.x * GW_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t row[G];
#pragma unroll
  for (int k = 0; k < G; ++k) row[k] = k < w.count ? __ldg(w.src[k] + i) : 0u;
  reinterpret_cast<typename GwVec<G>::T*>(packed)[i] = GwVec<G>::make(row);
}

// dst[k][i] = packed[perm[i] * G + k] for k < w.count.
template <int G>
static __global__ void __launch_bounds__(GW_THREADS)
    gather_words_packed(const int32_t* perm, int64_t n, const uint32_t* packed, WordPtrs w) {
  using T = typename GwVec<G>::T;
  constexpr int R = GW_ROWS;
  const int64_t i0 = ((int64_t)blockIdx.x * GW_THREADS + threadIdx.x) * R;
  if (i0 >= n) return;
  const int64_t left = n - i0;
  const bool whole = left >= R;
  uint32_t p[R];
  gw_load_run(reinterpret_cast<const uint32_t*>(perm) + i0, whole, left, p);
  T rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (whole || r < left) rows[r] = __ldg(reinterpret_cast<const T*>(packed) + p[r]);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k >= w.count) break;
    uint32_t v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t words[G];
      GwVec<G>::put(words, rows[r]);
      v[r] = words[k];
    }
    gw_store_run(w.dst[k] + i0, whole, left, v);
  }
}

// dst[k][i] = src[k][perm[i]] for k < w.count (at most MAX_WORDS).
static __global__ void __launch_bounds__(GW_THREADS)
    gather_words_direct(const int32_t* perm, int64_t n, WordPtrs w) {
  constexpr int R = GW_ROWS;
  const int64_t i0 = ((int64_t)blockIdx.x * GW_THREADS + threadIdx.x) * R;
  if (i0 >= n) return;
  const int64_t left = n - i0;
  const bool whole = left >= R;
  uint32_t p[R];
  gw_load_run(reinterpret_cast<const uint32_t*>(perm) + i0, whole, left, p);
  uint32_t v[MAX_WORDS][R];
#pragma unroll
  for (int k = 0; k < MAX_WORDS; ++k) {
    if (k >= w.count) break;
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[k][r] = (whole || r < left) ? __ldg(w.src[k] + p[r]) : 0u;
  }
#pragma unroll
  for (int k = 0; k < MAX_WORDS; ++k) {
    if (k >= w.count) break;
    gw_store_run(w.dst[k] + i0, whole, left, v[k]);
  }
}

inline bool gw_aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16u == 0; }

// extra_out[j][i] = extra_in[j][perm[i]] for nextra contiguous u32 columns,
// under the host's plan: packed (groups of GW_PACK_WORDS words, a group of
// one direct) or direct (groups of MAX_WORDS).  perm and every extra_out
// 16-byte aligned.  `free` holds at least 4n + 4 words (the sort's key and
// value buffers).
inline int gather_extras(const int32_t* perm, int64_t n, const void* const* extra_in,
                         void* const* extra_out, int nextra, int packed, uint32_t* free,
                         cudaStream_t st) {
  if (nextra <= 0 || n <= 0) return 0;
  if ((packed != 0 && packed != 1) || n > (int64_t)INT32_MAX || !gw_aligned(perm))
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < nextra; ++j)
    if (!gw_aligned(extra_out[j])) return (int)cudaErrorInvalidValue;
  uint32_t* buf = reinterpret_cast<uint32_t*>((reinterpret_cast<uintptr_t>(free) + 15) &
                                              ~(uintptr_t)15);
  const unsigned blocks = blocks_for(n, (int64_t)GW_THREADS * GW_ROWS);
  const int step = packed ? GW_PACK_WORDS : MAX_WORDS;
  for (int first = 0; first < nextra; first += step) {
    const int cnt = nextra - first < step ? nextra - first : step;
    const WordPtrs w = word_ptrs(extra_in, extra_out, first, cnt);
    if (!packed || cnt == 1) {
      gather_words_direct<<<blocks, GW_THREADS, 0, st>>>(perm, n, w);
    } else if (cnt == 2) {
      gather_words_pack<2><<<blocks_for(n, GW_THREADS), GW_THREADS, 0, st>>>(n, w, buf);
      DBT_CHECK_LAUNCH();
      gather_words_packed<2><<<blocks, GW_THREADS, 0, st>>>(perm, n, buf, w);
    } else {
      gather_words_pack<4><<<blocks_for(n, GW_THREADS), GW_THREADS, 0, st>>>(n, w, buf);
      DBT_CHECK_LAUNCH();
      gather_words_packed<4><<<blocks, GW_THREADS, 0, st>>>(perm, n, buf, w);
    }
    DBT_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace dbt
