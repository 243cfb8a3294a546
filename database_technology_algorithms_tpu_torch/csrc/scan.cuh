// Three-phase segmented scan over (flag, u32 value) pairs.
//
// The segmented monoid: combine(a, b) = (a.f | b.f, b.f ? b.v : op(a.v, b.v)),
// identity (0, e).  A scan with no flags is a plain scan.
//
//   1. scan_reduce: each block reduces its tile of SCAN_TILE positions, in
//      order, to one pair;
//   2. scan_carries: one block turns the per-tile pairs into exclusive
//      carries, in place;
//   3. scan_down: each block scans its tile again, starting from its carry.
//
// Tiles pass through shared memory so that global loads and stores are
// coalesced; each thread then scans SCAN_ITEMS consecutive positions.
// `reverse` reads logical position p at index n-1-p, which gives
// flip(scan(flip(flags), flip(vals))) without materializing the flips.
#pragma once

#include "common.cuh"

namespace dbt {

enum { SCAN_ADD = 0, SCAN_MIN = 1, SCAN_MAX = 2 };

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SCAN_CARRY_THREADS = 1024;

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

template <class V>
__device__ __forceinline__ void scan_load_tile(const uint8_t* flags, const uint32_t* vals,
                                               int64_t n, bool reverse, int64_t tile0,
                                               uint32_t* s_v, uint8_t* s_f) {
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = k * SCAN_THREADS + threadIdx.x;
    const int64_t pos = tile0 + j;
    if (pos < n) {
      const int64_t idx = reverse ? n - 1 - pos : pos;
      s_v[j] = vals[idx];
      s_f[j] = flags ? (flags[idx] != 0) : 0;
    } else {
      s_v[j] = V::identity();
      s_f[j] = 0;
    }
  }
}

template <class V>
__device__ __forceinline__ SegPair scan_thread_total(const uint32_t* s_v, const uint8_t* s_f) {
  SegPair acc = seg_identity<V>();
  const int base = threadIdx.x * SCAN_ITEMS;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    SegPair x;
    x.f = s_f[base + i];
    x.v = s_v[base + i];
    acc = seg_combine<V>(acc, x);
  }
  return acc;
}

template <class V>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_reduce(const uint8_t* flags, const uint32_t* vals, int64_t n, bool reverse,
            uint32_t* agg_f, uint32_t* agg_v) {
  __shared__ uint32_t s_v[SCAN_TILE];
  __shared__ uint8_t s_f[SCAN_TILE];
  __shared__ SegPair s_warp[32];
  const int64_t tile0 = (int64_t)blockIdx.x * SCAN_TILE;
  scan_load_tile<V>(flags, vals, n, reverse, tile0, s_v, s_f);
  __syncthreads();
  SegPair total;
  block_exclusive_scan<V>(scan_thread_total<V>(s_v, s_f), &total, s_warp);
  if (threadIdx.x == 0) {
    agg_f[blockIdx.x] = total.f;
    agg_v[blockIdx.x] = total.v;
  }
}

template <class V>
__global__ void __launch_bounds__(SCAN_CARRY_THREADS)
scan_carries(uint32_t* agg_f, uint32_t* agg_v, int64_t nb) {
  __shared__ SegPair s_warp[32];
  SegPair carry = seg_identity<V>();
  for (int64_t base = 0; base < nb; base += blockDim.x) {
    const int64_t i = base + threadIdx.x;
    SegPair x = seg_identity<V>();
    if (i < nb) {
      x.f = agg_f[i];
      x.v = agg_v[i];
    }
    SegPair total;
    SegPair ex = block_exclusive_scan<V>(x, &total, s_warp);
    if (i < nb) {
      SegPair c = seg_combine<V>(carry, ex);
      agg_f[i] = c.f;
      agg_v[i] = c.v;
    }
    carry = seg_combine<V>(carry, total);
  }
}

template <class V>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_down(const uint8_t* flags, const uint32_t* vals, uint32_t* out, int64_t n, bool reverse,
          const uint32_t* carry_f, const uint32_t* carry_v) {
  __shared__ uint32_t s_v[SCAN_TILE];
  __shared__ uint8_t s_f[SCAN_TILE];
  __shared__ SegPair s_warp[32];
  const int64_t tile0 = (int64_t)blockIdx.x * SCAN_TILE;
  scan_load_tile<V>(flags, vals, n, reverse, tile0, s_v, s_f);
  __syncthreads();
  SegPair total;
  SegPair ex = block_exclusive_scan<V>(scan_thread_total<V>(s_v, s_f), &total, s_warp);
  SegPair run;
  run.f = carry_f[blockIdx.x];
  run.v = carry_v[blockIdx.x];
  run = seg_combine<V>(run, ex);
  const int base = threadIdx.x * SCAN_ITEMS;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    SegPair x;
    x.f = s_f[base + i];
    x.v = s_v[base + i];
    run = seg_combine<V>(run, x);
    s_v[base + i] = run.v;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int j = k * SCAN_THREADS + threadIdx.x;
    const int64_t pos = tile0 + j;
    if (pos < n) out[reverse ? n - 1 - pos : pos] = s_v[j];
  }
}

inline int64_t seg_scan_scratch_words(int64_t n) {
  return 2 * ((n + SCAN_TILE - 1) / SCAN_TILE);
}

// Inclusive segmented scan of n pairs; scratch holds seg_scan_scratch_words(n)
// words.  flags may be null (a plain scan).
template <class V>
int seg_scan_launch(const uint8_t* flags, const uint32_t* vals, uint32_t* out,
                    uint32_t* scratch, int64_t n, bool reverse, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int64_t nb = (n + SCAN_TILE - 1) / SCAN_TILE;
  uint32_t* agg_f = scratch;
  uint32_t* agg_v = scratch + nb;
  scan_reduce<V><<<(unsigned)nb, SCAN_THREADS, 0, stream>>>(flags, vals, n, reverse, agg_f, agg_v);
  DBT_CHECK_LAUNCH();
  scan_carries<V><<<1, SCAN_CARRY_THREADS, 0, stream>>>(agg_f, agg_v, nb);
  DBT_CHECK_LAUNCH();
  scan_down<V><<<(unsigned)nb, SCAN_THREADS, 0, stream>>>(flags, vals, out, n, reverse, agg_f, agg_v);
  DBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace dbt
