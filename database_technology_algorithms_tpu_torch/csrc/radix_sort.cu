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
// 8-bit passes over the key, then one pass on the inact bit (radix.cuh has
// the pass; the key column moves with the row index, so every read is
// sequential).  The first pass makes the row index on the fly; the last
// writes s_act and the final outputs directly.  Extra words are gathered by
// perm afterwards.
#include "radix.cuh"

DBT_API int64_t dbt_view_sort_scratch_words(int64_t n) {
  return 4 * n + dbt::radix_scratch_words(n);
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
  uint32_t* ka = static_cast<uint32_t*>(scratch);
  uint32_t* kb = ka + n;
  int32_t* va = reinterpret_cast<int32_t*>(kb + n);
  int32_t* vb = va + n;
  const dbt::RadixScratch rs = dbt::radix_scratch(reinterpret_cast<uint32_t*>(vb + n), n);

  const uint32_t* kin = static_cast<const uint32_t*>(key);
  const int32_t* vin = nullptr;  // pass 0 makes the row index
  uint32_t* kouts[4] = {ka, kb, ka, kb};
  int32_t* vouts[4] = {va, vb, va, vb};
  for (int p = 0; p < 4; ++p) {
    int err = dbt::radix_pass<dbt::DIGIT_KEY>(kin, 1, vin, nullptr, kouts[p], vouts[p], nullptr,
                                              n, 8 * p, rs, st);
    if (err) return err;
    kin = kouts[p];
    vin = vouts[p];
  }
  // most significant: the inactive bit (actives first)
  int err = dbt::radix_pass<dbt::DIGIT_INACT>(
      kin, 1, vin, in_act, static_cast<uint32_t*>(s_key), static_cast<int32_t*>(perm),
      static_cast<uint8_t*>(s_act), n, 0, rs, st);
  if (err) return err;
  return dbt::gather_extras(static_cast<const int32_t*>(perm), n, extra_in, extra_out, nextra, st);
}
