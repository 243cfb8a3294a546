// One stable radix pass over (digit source, row index) pairs, shared by the
// view sort K1 (radix_sort.cu) and the multi-word sort K5 (words_sort.cu).
//
// A pass is
//   histogram (per tile, shared-memory atomics)
//   -> exclusive scan of the digit-major counts (scan.cuh)
//   -> stable scatter: a tile is walked in order, 256 rows at a time; a row's
//      rank among equal digits comes from __match_any_sync inside its warp
//      and a per-digit prefix over the block's warps.
// The value that moves is the row index; the first pass makes it on the fly
// (vals == nullptr means val = position).  Where the digit comes from is the
// pass's mode:
//   DIGIT_KEY     8 bits of keys[i], a key column that moves with the values
//                 (sequential reads; the key is written on to keys_out);
//   DIGIT_GATHER  8 bits of keys[val * stride], a column that stays where it
//                 is and is read through the current order (any row stride,
//                 so a column of a row-major [N, K] matrix needs no copy);
//   DIGIT_INACT   the row's inactive flag, inact[val] (digits 0 and 1;
//                 actives first).  It also writes the sorted activity mask.
#pragma once

#include "scan.cuh"

namespace dbt {

constexpr int R_THREADS = 256;
constexpr int R_WARPS = R_THREADS / 32;
constexpr int R_ITEMS = 16;
constexpr int64_t R_TILE = (int64_t)R_THREADS * R_ITEMS;
constexpr int RADIX = 256;  // 8-bit digits; the inact pass uses digits 0 and 1
static_assert(RADIX == R_THREADS, "one thread per digit in the scatter's warp prefix");

enum { DIGIT_KEY = 0, DIGIT_GATHER = 1, DIGIT_INACT = 2 };

// The key word a row carries through this pass (0 where there is none).
template <int MODE>
__device__ __forceinline__ uint32_t radix_key(const uint32_t* keys, int64_t stride, int64_t i,
                                              int32_t val) {
  if constexpr (MODE == DIGIT_GATHER) return keys[(int64_t)val * stride];
  else return keys ? keys[i] : 0u;
}

template <int MODE>
__device__ __forceinline__ int radix_digit(uint32_t key, int32_t val, const uint8_t* inact,
                                           int shift) {
  if constexpr (MODE == DIGIT_INACT) return inact[val] ? 1 : 0;
  else return (int)((key >> shift) & (RADIX - 1));
}

// counts[d * nb + b] = number of rows of tile b whose digit is d
template <int MODE>
__global__ void __launch_bounds__(R_THREADS)
radix_hist(const uint32_t* keys, int64_t stride, const int32_t* vals, const uint8_t* inact,
           uint32_t* counts, int64_t n, int shift, int64_t nb) {
  __shared__ uint32_t s_hist[RADIX];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t tile0 = (int64_t)blockIdx.x * R_TILE;
  for (int it = 0; it < R_ITEMS; ++it) {
    const int64_t i = tile0 + (int64_t)it * R_THREADS + threadIdx.x;
    if (i < n) {
      const int32_t val = vals ? vals[i] : (int32_t)i;
      const uint32_t key = MODE == DIGIT_INACT ? 0u : radix_key<MODE>(keys, stride, i, val);
      atomicAdd(&s_hist[radix_digit<MODE>(key, val, inact, shift)], 1u);
    }
  }
  __syncthreads();
  counts[(int64_t)threadIdx.x * nb + blockIdx.x] = s_hist[threadIdx.x];
}

// Stable scatter of tile b: rows go to incl[d*nb+b] - counts[d*nb+b] (the
// exclusive offset of digit d for this tile) plus their rank among earlier
// rows of the tile with the same digit.  keys_out and act_out may be null.
template <int MODE>
__global__ void __launch_bounds__(R_THREADS)
radix_scatter(const uint32_t* keys_in, int64_t stride, const int32_t* vals_in,
              const uint8_t* inact, uint32_t* keys_out, int32_t* vals_out, uint8_t* act_out,
              const uint32_t* counts, const uint32_t* incl, int64_t n, int shift, int64_t nb) {
  __shared__ uint32_t s_base[RADIX];
  __shared__ uint32_t s_warp[R_WARPS][RADIX];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  {
    const int64_t c = (int64_t)tid * nb + blockIdx.x;
    s_base[tid] = incl[c] - counts[c];
  }
  const int64_t tile0 = (int64_t)blockIdx.x * R_TILE;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int it = 0; it < R_ITEMS; ++it) {
#pragma unroll
    for (int w = 0; w < R_WARPS; ++w) s_warp[w][tid] = 0;
    __syncthreads();
    const int64_t i = tile0 + (int64_t)it * R_THREADS + tid;
    const bool live = i < n;
    uint32_t key = 0;
    int32_t val = 0;
    int digit = 0;
    int rank = 0;
    if (live) {
      val = vals_in ? vals_in[i] : (int32_t)i;
      key = radix_key<MODE>(keys_in, stride, i, val);
      digit = radix_digit<MODE>(key, val, inact, shift);
    }
    const unsigned live_mask = __ballot_sync(FULL_MASK, live);
    if (live) {
      const unsigned peers = __match_any_sync(live_mask, digit);
      rank = __popc(peers & lanes_below);
      if (rank == 0) s_warp[warp][digit] = __popc(peers);
    }
    __syncthreads();
    {
      // thread tid owns digit tid: warp counts -> exclusive offsets
      uint32_t run = s_base[tid];
#pragma unroll
      for (int w = 0; w < R_WARPS; ++w) {
        const uint32_t c = s_warp[w][tid];
        s_warp[w][tid] = run;
        run += c;
      }
      s_base[tid] = run;
    }
    __syncthreads();
    if (live) {
      const uint32_t dst = s_warp[warp][digit] + rank;
      if (keys_out) keys_out[dst] = key;
      vals_out[dst] = val;
      if constexpr (MODE == DIGIT_INACT) {
        if (act_out) act_out[dst] = digit == 0;
      }
    }
    __syncthreads();  // the next row chunk zeroes s_warp
  }
}

// The three scratch arrays a pass needs, cut from one buffer of
// radix_scratch_words(n) words.
struct RadixScratch {
  uint32_t* counts;
  uint32_t* incl;
  uint32_t* scan;
  int64_t nb;
  int64_t nc;
};

inline int64_t radix_tiles(int64_t n) { return (n + R_TILE - 1) / R_TILE; }

inline int64_t radix_scratch_words(int64_t n) {
  const int64_t nc = (int64_t)RADIX * radix_tiles(n);
  return 2 * nc + seg_scan_scratch_words(nc);
}

inline RadixScratch radix_scratch(uint32_t* base, int64_t n) {
  RadixScratch s;
  s.nb = radix_tiles(n);
  s.nc = (int64_t)RADIX * s.nb;
  s.counts = base;
  s.incl = base + s.nc;
  s.scan = s.incl + s.nc;
  return s;
}

// One pass: histogram, scan, scatter.  vals_in must not alias vals_out.
template <int MODE>
inline int radix_pass(const uint32_t* keys_in, int64_t stride, const int32_t* vals_in,
                      const uint8_t* inact, uint32_t* keys_out, int32_t* vals_out,
                      uint8_t* act_out, int64_t n, int shift, const RadixScratch& s,
                      cudaStream_t st) {
  radix_hist<MODE><<<(unsigned)s.nb, R_THREADS, 0, st>>>(
      keys_in, stride, vals_in, inact, s.counts, n, shift, s.nb);
  DBT_CHECK_LAUNCH();
  int err = seg_scan_launch<ValOp<SCAN_ADD, false>>(nullptr, s.counts, s.incl, s.scan, s.nc,
                                                   false, st);
  if (err) return err;
  radix_scatter<MODE><<<(unsigned)s.nb, R_THREADS, 0, st>>>(
      keys_in, stride, vals_in, inact, keys_out, vals_out, act_out, s.counts, s.incl, n, shift,
      s.nb);
  DBT_CHECK_LAUNCH();
  return 0;
}

static __global__ void gather_words(const int32_t* perm, int64_t n, WordPtrs w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t p = perm[i];
  for (int k = 0; k < w.count; ++k) w.dst[k][i] = w.src[k][p];
}

// extra_out[j][i] = extra_in[j][perm[i]] for nextra contiguous u32 columns.
inline int gather_extras(const int32_t* perm, int64_t n, const void* const* extra_in,
                         void* const* extra_out, int nextra, cudaStream_t st) {
  for (int first = 0; first < nextra; first += MAX_WORDS) {
    const int cnt = nextra - first < MAX_WORDS ? nextra - first : MAX_WORDS;
    gather_words<<<blocks_for(n, 256), 256, 0, st>>>(
        perm, n, word_ptrs(extra_in, extra_out, first, cnt));
    DBT_CHECK_LAUNCH();
  }
  return 0;
}

}  // namespace dbt
