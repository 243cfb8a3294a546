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
// per operand); here the design is the one-sweep LSD radix sort of
// radix.cuh over the 33-bit (inact, key) composite with the row index as
// the value, so stability gives the row-index tie-break without any digit
// passes over it.  The schedule (kernels/radix_plan.py) has four passes of
// 8, 8, 8 and 9 bits: the top digit is key >> 24 with the inactive flag
// above it (512 buckets), the flag riding in bit 31 of the value from the
// first pass on, so no pass of its own.  One histogram launch reads key and
// inact once; each pass is one launch; a pass whose digit is constant (the
// key's high byte when keys are small and every row is active, the main
// path's case) is skipped, decided on the card.  The last pass that
// scatters writes s_key, perm and s_act.  Extra words are gathered by perm
// afterwards (gather_extras in radix.cuh: packed or direct rows, the plan's).
#include "radix.cuh"

// Scratch of the one-sweep sort (K1, K5) of n rows in npasses passes.
DBT_API int64_t dbt_radix_scratch_words(int64_t n, int npasses) {
  return dbt::radix_scratch_words(n, npasses);
}

// key u32[n], inact u8[n] -> s_key u32[n], perm i32[n], s_act u8[n];
// extra_out[j][i] = extra_in[j][perm[i]], gathered under the plan
// (gather_packed: kernels/radix_plan.gather_packed); perm and every
// extra_out 16-byte aligned.
// sched: npasses (word, shift, flag) triples on the host, every word 0, the
// last pass flagged.  scratch: dbt_radix_scratch_words(n, npasses); its
// first npasses words hold the kinds of the passes afterwards (1 trivial, 2
// scattered).
DBT_API int dbt_view_sort(const void* key, const void* inact, int64_t n, const int32_t* sched,
                          int npasses, void* s_key, void* perm, void* s_act,
                          const void* const* extra_in, void* const* extra_out, int nextra,
                          int gather_packed, void* scratch, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* words[1] = {key};
  const int64_t strides[1] = {1};
  dbt::RadixIO io;
  io.cols = dbt::key_cols(words, strides, 1);
  io.inact = static_cast<const uint8_t*>(inact);
  io.keys_out = static_cast<uint32_t*>(s_key);
  io.perm_out = static_cast<int32_t*>(perm);
  io.act_out = static_cast<uint8_t*>(s_act);
  int err = dbt::radix_sort(io, sched, npasses, n, static_cast<uint32_t*>(scratch), st);
  if (err) return err;
  return dbt::gather_extras(static_cast<const int32_t*>(perm), n, extra_in, extra_out, nextra,
                            gather_packed,
                            dbt::radix_key_buffers(static_cast<uint32_t*>(scratch), n, npasses),
                            st);
}
