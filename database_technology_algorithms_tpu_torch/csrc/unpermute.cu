// K7: un-permute — per-sorted-row answers back to original row order, in two
// forms.
//
// The scatter replaces the back-sorts of the JAX package that return a word
// computed at sorted positions to the rows it belongs to: the hash join's
// sort by (probe ? perm : n) carrying the multiplicity or the packed match
// bit (ops/hash_join.py:242-253); packed_keep_backsort (ops/movement.py:235)
// and survivor_dest's un-permute (ops/sort.py:240) are the same function.
// out[perm[i] - lo] = vals[i] for every i with lo <= perm[i] < lo + m.
// perm is a permutation of [0, n), so no two rows write one slot and every
// slot of out is written exactly once.
//
// The gather replaces the tiled join's return of its counts to probe order
// (ops/hash_join.py:470-489, a compaction of the occupied slots and a sort
// by the staging permutation, chosen because a random gather was slow on
// the TPU): out[i] = vals[first[s / cap] + s % cap] for s = slot_of_row[i]
// when i < count and s < nparts * cap, else 0.  K9's "slots" row map gives
// s in row order, and K10 writes the counts of cell c's live rows compacted
// from first[c], so the counts come back with one coalesced read of the
// slots, a cached read of first and one 4-byte read a live row.
//
// Bound on the H100: bytes.  The scatter reads perm and vals and writes the
// values in range, one thread a row, with coalesced reads and random writes:
// a sort is not needed to invert a permutation.  The gather reads the live
// rows' slots and values and writes every output row; a thread owns R
// consecutive rows (kernels/perm_plan.py), whose slots it loads as 16-byte
// vectors before any branch, in a grid of a few waves of the blocks the card
// holds, which walk the rows.  It divides by cap with a host-made multiplier
// (perm_plan.div_magic), never a 64-bit divide.  What the card waits on is
// the random accesses, one a live row (a scattered 4-byte store, a gathered
// 4-byte read), each an L2 transaction of its own: tools/perm_sweep.py finds
// no R or grid of the scatter faster than one row a thread, and the gather
// fastest at R = 4 in two waves.
#include "common.cuh"

namespace {

constexpr int UP_THREADS = 256;

// R, rows a thread of the gather (perm_plan.GATHER_ROWS); tools/perm_sweep.py
// builds copies with other values
#ifndef UP_GATHER_R
#define UP_GATHER_R 4
#endif

// R consecutive int32 words from p (16-byte vectors where `vec`, else one
// at a time, those below n; the rest get `fill`).
template <int R>
__device__ __forceinline__ void load_words(const int32_t* p, bool vec, int64_t i0, int64_t n,
                                           int32_t fill, int32_t (&x)[R]) {
  if (R % 4 == 0 && vec && i0 + R <= n) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(p + i0) + q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = i0 + r < n ? __ldcs(p + i0 + r) : fill;
  }
}

template <class T>
__global__ void unpermute_kernel(const int32_t* perm, const T* vals, int64_t n, int64_t lo,
                                 int64_t m, T* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t d = (int64_t)perm[i] - lo;
  if (d >= 0 && d < m) out[d] = vals[i];
}

template <int R>
__global__ void __launch_bounds__(UP_THREADS)
    unpermute_gather(const int32_t* slot_of_row, const int32_t* count, int64_t count_host,
                     int64_t n, const int32_t* first, uint32_t cap, uint32_t nslots,
                     uint64_t mult, int shift, const uint32_t* vals, int64_t nvals,
                     uint32_t* out, int vec) {
  static_assert(R == 1 || R % 4 == 0, "R rows must fill 16-byte vectors");
  int64_t live = count_host;
  if (count) {
    const int64_t c = *count;
    live = c < 0 ? 0 : (c > n ? n : c);
  }
  const int64_t stride = (int64_t)gridDim.x * UP_THREADS * R;
  for (int64_t i0 = ((int64_t)blockIdx.x * UP_THREADS + threadIdx.x) * R; i0 < n; i0 += stride) {
    int32_t s[R];
    // slots of the rows below the live count only; a row past it is empty
    load_words<R>(slot_of_row, vec != 0, i0, live, (int32_t)nslots, s);
    uint32_t o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t sl = (uint32_t)s[r];
      o[r] = 0u;
      if (sl < nslots) {
        const uint32_t cell = (uint32_t)(((uint64_t)sl * mult) >> shift);
        const int64_t at = (int64_t)__ldg(first + cell) + (sl - cell * cap);
        if (at >= 0 && at < nvals) o[r] = __ldg(vals + at);
      }
    }
    if (R % 4 == 0 && vec && i0 + R <= n) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
        __stcs(reinterpret_cast<uint4*>(out + i0) + q,
               make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]));
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r < n) out[i0 + r] = o[r];
    }
  }
}

}  // namespace

// perm i32[n]; vals and out hold elem_bytes (4: u32/i32 words, 1: bool)
// per element, n and m of them.
DBT_API int dbt_unpermute(const void* perm, const void* vals, int64_t n, int64_t lo, int64_t m,
                          void* out, int elem_bytes, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* p = static_cast<const int32_t*>(perm);
  if (elem_bytes == 4) {
    unpermute_kernel<uint32_t><<<dbt::blocks_for(n, 256), 256, 0, st>>>(
        p, static_cast<const uint32_t*>(vals), n, lo, m, static_cast<uint32_t*>(out));
  } else if (elem_bytes == 1) {
    unpermute_kernel<uint8_t><<<dbt::blocks_for(n, 256), 256, 0, st>>>(
        p, static_cast<const uint8_t*>(vals), n, lo, m, static_cast<uint8_t*>(out));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  DBT_CHECK_LAUNCH();
  return 0;
}

// slot_of_row i32[n] (K9's "slots"); count: a device int32 live count or
// null, then count_host rows are live; first i32[nparts] (cell c's first
// value); vals u32[nvals]; out u32[n].  mult and shift divide a slot by cap
// (perm_plan.div_magic); rows: R, which must be UP_GATHER_R; vec nonzero
// where slot_of_row and out are 16-byte aligned; blocks: the grid.
DBT_API int dbt_unpermute_gather(const void* slot_of_row, const void* count, int64_t count_host,
                                 int64_t n, const void* first, int64_t nparts, int64_t cap,
                                 uint64_t mult, int shift, const void* vals, int64_t nvals,
                                 void* out, int rows, int vec, int blocks, void* stream) {
  if (n > INT32_MAX || nparts < 1 || cap < 1 || nparts * cap > INT32_MAX || blocks < 1 ||
      shift < 31 || shift > 62 || rows != UP_GATHER_R)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  unpermute_gather<UP_GATHER_R><<<blocks, UP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slot_of_row), static_cast<const int32_t*>(count), count_host,
      n, static_cast<const int32_t*>(first), (uint32_t)cap, (uint32_t)(nparts * cap), mult, shift,
      static_cast<const uint32_t*>(vals), nvals, static_cast<uint32_t*>(out), vec);
  DBT_CHECK_LAUNCH();
  return 0;
}
