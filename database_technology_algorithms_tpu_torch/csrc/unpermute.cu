// K7: un-permute — per-sorted-row answers back to original row order.
//
// Replaces the back-sorts of the JAX package that return a word computed at
// sorted positions to the rows it belongs to: the hash join's sort by
// (probe ? perm : n) carrying the multiplicity or the packed match bit
// (ops/hash_join.py:242-253); packed_keep_backsort (ops/movement.py:235)
// and survivor_dest's un-permute (ops/sort.py:240) are the same function.
// out[perm[i] - lo] = vals[i] for every i with lo <= perm[i] < lo + m.
// perm is a permutation of [0, n), so no two rows write one slot and every
// slot of out is written exactly once.
//
// Bound on the H100: bytes.  Per row it reads the 4-byte perm entry and the
// value and writes the value for the rows in range.  A sort is not needed
// to invert a permutation: one scatter does it, one thread per row, with
// coalesced reads and random writes.
#include "common.cuh"

namespace {

template <class T>
__global__ void unpermute_kernel(const int32_t* perm, const T* vals, int64_t n, int64_t lo,
                                 int64_t m, T* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t d = (int64_t)perm[i] - lo;
  if (d >= 0 && d < m) out[d] = vals[i];
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
