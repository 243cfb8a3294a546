// K1: the pipeline's view sort.
//
// Replaces the JAX package's packed_u32_view_sort (ops/sort.py:190), a
// 2-operand lax.sort of the bit-packed words (inact<<31 | key>>1,
// (key&1)<<31 | row).  It sorts N rows by (inact, u32 key, row index) and
// returns the sorted key, the permutation (row indices), the sorted activity
// mask and the carried extra words.  The row index is one of the sort keys,
// so the order is total and any correct sort is bit-identical to JAX's.
//
// Bound on the H100: bytes.  The function reads key (4 B) and inact (1 B)
// per row and writes s_key (4 B), perm (4 B) and s_act (1 B), plus 4 B in
// and 4 B out per extra word.  The packing was a TPU device (lax.sort costs
// per operand); here the design is a stable LSD radix sort over the 33-bit
// (inact, key) composite with the row index as the value, so stability
// gives the row-index tie-break without any digit passes over it: four
// 8-bit passes over the key, then one pass on the inact bit.  Each pass is
//   histogram (per tile, shared-memory atomics)
//   -> exclusive scan of the digit-major counts (scan.cuh)
//   -> stable scatter: a tile is walked in order, 256 rows at a time; a row's
//      rank among equal digits comes from __match_any_sync inside its warp
//      and a per-digit prefix over the block's warps.
// The first pass makes the row index on the fly; the last writes s_act and
// the final outputs directly.  Extra words are gathered by perm afterwards.
#include "scan.cuh"

namespace {

constexpr int R_THREADS = 256;
constexpr int R_WARPS = R_THREADS / 32;
constexpr int R_ITEMS = 16;
constexpr int64_t R_TILE = (int64_t)R_THREADS * R_ITEMS;
constexpr int RADIX = 256;  // 8-bit digits; the inact pass uses digits 0 and 1
static_assert(RADIX == R_THREADS, "one thread per digit in the scatter's warp prefix");

template <bool INACT_PASS>
__device__ __forceinline__ int radix_digit(uint32_t key, int32_t val, const uint8_t* inact, int shift) {
  if constexpr (INACT_PASS) return inact[val] ? 1 : 0;
  else return (int)((key >> shift) & (RADIX - 1));
}

// counts[d * nb + b] = number of rows of tile b whose digit is d
template <bool INACT_PASS>
__global__ void __launch_bounds__(R_THREADS)
radix_hist(const uint32_t* keys, const int32_t* vals, const uint8_t* inact,
           uint32_t* counts, int64_t n, int shift, int64_t nb) {
  __shared__ uint32_t s_hist[RADIX];
  s_hist[threadIdx.x] = 0;
  __syncthreads();
  const int64_t tile0 = (int64_t)blockIdx.x * R_TILE;
  for (int it = 0; it < R_ITEMS; ++it) {
    const int64_t i = tile0 + (int64_t)it * R_THREADS + threadIdx.x;
    if (i < n) {
      const int32_t val = vals ? vals[i] : (int32_t)i;
      atomicAdd(&s_hist[radix_digit<INACT_PASS>(keys[i], val, inact, shift)], 1u);
    }
  }
  __syncthreads();
  counts[(int64_t)threadIdx.x * nb + blockIdx.x] = s_hist[threadIdx.x];
}

// Stable scatter of tile b: rows go to incl[d*nb+b] - counts[d*nb+b] (the
// exclusive offset of digit d for this tile) plus their rank among earlier
// rows of the tile with the same digit.  vals == nullptr means val = row.
template <bool INACT_PASS>
__global__ void __launch_bounds__(R_THREADS)
radix_scatter(const uint32_t* keys_in, const int32_t* vals_in, const uint8_t* inact,
              uint32_t* keys_out, int32_t* vals_out, uint8_t* act_out,
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
      key = keys_in[i];
      val = vals_in ? vals_in[i] : (int32_t)i;
      digit = radix_digit<INACT_PASS>(key, val, inact, shift);
    }
    const unsigned live_mask = __ballot_sync(dbt::FULL_MASK, live);
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
      keys_out[dst] = key;
      vals_out[dst] = val;
      if constexpr (INACT_PASS) act_out[dst] = digit == 0;
    }
    __syncthreads();  // the next row chunk zeroes s_warp
  }
}

__global__ void gather_words(const int32_t* perm, int64_t n, dbt::WordPtrs w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t p = perm[i];
  for (int k = 0; k < w.count; ++k) w.dst[k][i] = w.src[k][p];
}

}  // namespace

DBT_API int64_t dbt_view_sort_scratch_words(int64_t n) {
  const int64_t nc = (int64_t)RADIX * ((n + R_TILE - 1) / R_TILE);
  return 4 * n + 2 * nc + dbt::seg_scan_scratch_words(nc);
}

// key u32[n], inact u8[n] -> s_key u32[n], perm i32[n], s_act u8[n];
// extra_out[j][i] = extra_in[j][perm[i]].  scratch: dbt_view_sort_scratch_words(n).
DBT_API int dbt_view_sort(const void* key, const void* inact, int64_t n,
                          void* s_key, void* perm, void* s_act,
                          const void* const* extra_in, void* const* extra_out, int nextra,
                          void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in_act = static_cast<const uint8_t*>(inact);
  const int64_t nb = (n + R_TILE - 1) / R_TILE;
  const int64_t nc = (int64_t)RADIX * nb;
  uint32_t* ka = static_cast<uint32_t*>(scratch);
  uint32_t* kb = ka + n;
  int32_t* va = reinterpret_cast<int32_t*>(kb + n);
  int32_t* vb = va + n;
  uint32_t* counts = reinterpret_cast<uint32_t*>(vb + n);
  uint32_t* incl = counts + nc;
  uint32_t* scan_scratch = incl + nc;
  using Add = dbt::ValOp<dbt::SCAN_ADD, false>;

  const uint32_t* kin = static_cast<const uint32_t*>(key);
  const int32_t* vin = nullptr;  // pass 0 makes the row index
  uint32_t* kouts[4] = {ka, kb, ka, kb};
  int32_t* vouts[4] = {va, vb, va, vb};
  for (int p = 0; p < 4; ++p) {
    radix_hist<false><<<(unsigned)nb, R_THREADS, 0, st>>>(kin, vin, nullptr, counts, n, 8 * p, nb);
    DBT_CHECK_LAUNCH();
    int err = dbt::seg_scan_launch<Add>(nullptr, counts, incl, scan_scratch, nc, false, st);
    if (err) return err;
    radix_scatter<false><<<(unsigned)nb, R_THREADS, 0, st>>>(
        kin, vin, nullptr, kouts[p], vouts[p], nullptr, counts, incl, n, 8 * p, nb);
    DBT_CHECK_LAUNCH();
    kin = kouts[p];
    vin = vouts[p];
  }
  // most significant: the inactive bit (actives first)
  radix_hist<true><<<(unsigned)nb, R_THREADS, 0, st>>>(kin, vin, in_act, counts, n, 0, nb);
  DBT_CHECK_LAUNCH();
  int err = dbt::seg_scan_launch<Add>(nullptr, counts, incl, scan_scratch, nc, false, st);
  if (err) return err;
  radix_scatter<true><<<(unsigned)nb, R_THREADS, 0, st>>>(
      kin, vin, in_act, static_cast<uint32_t*>(s_key), static_cast<int32_t*>(perm),
      static_cast<uint8_t*>(s_act), counts, incl, n, 0, nb);
  DBT_CHECK_LAUNCH();

  for (int first = 0; first < nextra; first += dbt::MAX_WORDS) {
    const int cnt = nextra - first < dbt::MAX_WORDS ? nextra - first : dbt::MAX_WORDS;
    gather_words<<<dbt::blocks_for(n, 256), 256, 0, st>>>(
        static_cast<const int32_t*>(perm), n, dbt::word_ptrs(extra_in, extra_out, first, cnt));
    DBT_CHECK_LAUNCH();
  }
  return 0;
}
