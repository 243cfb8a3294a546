// K6: exact adjacent-key equality under a permutation.
//
// Replaces the JAX package's rows_equal_on_field(batch, field, perm[:-1],
// perm[1:]) with its leading False (ops/keys.py:68-78, used by sort_keys at
// ops/sort.py:128-133,173,179-180): two whole-row gathers of the key
// columns and an all-reduce over the words.  adj[i] is true when sorted row
// i has the same full key as sorted row i-1; adj[0] is false.  A null perm
// compares the rows where they lie (ops/keys.py:81 adjacent_equal).
//
// Bound on the H100: bytes.  Per row it reads the 4-byte perm entry and the
// m key words of the row, and writes one byte.  One thread per sorted row
// reads its own row and its predecessor's word by word and stops at the
// first unequal word, so no gathered copy of the key is written and most
// unequal pairs cost one word each.  The predecessor's words were the
// neighbouring thread's own reads, so they come from L1/L2.
#include "common.cuh"

namespace {

__global__ void adj_equal_kernel(dbt::KeyCols c, const int32_t* perm, int64_t n, uint8_t* adj) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (i == 0) {
    adj[0] = 0;
    return;
  }
  const int64_t a = perm ? perm[i] : i;
  const int64_t b = perm ? perm[i - 1] : i - 1;
  bool eq = true;
  for (int k = 0; k < c.count && eq; ++k)
    eq = c.ptr[k][a * c.stride[k]] == c.ptr[k][b * c.stride[k]];
  adj[i] = eq;
}

}  // namespace

// words: m device pointers (host array) to u32 columns, the row stride of
// each in `strides` (host array, in words); perm i32[n] or null; adj u8[n].
DBT_API int dbt_adj_equal(const void* const* words, const int64_t* strides, int m,
                          const void* perm, int64_t n, void* adj, void* stream) {
  if (m < 1 || m > dbt::MAX_KEY_WORDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const dbt::KeyCols c = dbt::key_cols(words, strides, m);
  adj_equal_kernel<<<dbt::blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const int32_t*>(perm), n, static_cast<uint8_t*>(adj));
  DBT_CHECK_LAUNCH();
  return 0;
}
