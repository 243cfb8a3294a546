// K5: the multi-word key sort.
//
// Replaces the variadic lax.sort of the JAX package's sort_keys
// (ops/sort.py:151-153,159-161) and the stable two-word passes of its exact
// string fallback _lsd_exact_string_perm (ops/sort.py:63-96).  It orders N
// rows by (inact, word_0, ..., word_{m-1}, row index), the words compared as
// u32, most significant first, and returns the permutation, the sorted
// activity mask and the extra words gathered by the permutation.  The row
// index is the last sort key, so the order is total and any exact sort
// gives JAX's result bit for bit: the prefix fast path and its lax.cond
// fallback both equal one sort over every key word, which is what this is.
//
// Bound on the H100: bytes.  The function reads 4 B per word and 1 B of
// inact per row and writes perm (4 B) and s_act (1 B).  The design is the
// one-sweep LSD radix sort of radix.cuh: one histogram launch reads every
// word and inact once, in row order, then 8-bit passes from the last word's
// low byte up to the first word's high byte, the inactive flag folded into
// the top digit (a 9-bit digit, no pass of its own): 4m passes, one launch
// each (kernels/radix_plan.py).  A pass whose digit is constant (the NUL
// bytes that pad short strings) is skipped, decided on the card.  The first
// pass of a word to scatter reads it through the order so far,
// word[perm[i] * stride], so a column of a row-major [N, K] matrix is sorted
// where it lies; the word then moves with the row index through its other
// passes, at most m - 1 random reads a row in all (the first pass to scatter
// reads in row order).  Stability across tiles (a long run of equal keys
// spans many tiles) comes from the decoupled look-back's per-digit prefix.
#include "radix.cuh"

// words: m device pointers (host array) to u32 columns of n rows, the row
// stride of each in `strides` (host array, in words); inact u8[n] or null
// (every row active; s_act is then left untouched).  sched: npasses (word,
// shift, flag) triples on the host, the last pass flagged iff inact is
// given.  perm i32[n], s_act u8[n]; extra_out[j][i] = extra_in[j][perm[i]],
// gathered under the plan (gather_packed: kernels/radix_plan.gather_packed),
// perm and every extra_out 16-byte aligned.  scratch: dbt_radix_scratch_words(n,
// npasses); its first npasses words hold the kinds of the passes afterwards
// (1 trivial, 2 scattered).
DBT_API int dbt_words_sort(const void* const* words, const int64_t* strides, int m,
                           const int32_t* sched, int npasses, const void* inact, int64_t n,
                           void* perm, void* s_act, const void* const* extra_in,
                           void* const* extra_out, int nextra, int gather_packed,
                           void* scratch, void* stream) {
  if (m < 1 || m > dbt::MAX_KEY_WORDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dbt::RadixIO io;
  io.cols = dbt::key_cols(words, strides, m);
  io.inact = static_cast<const uint8_t*>(inact);
  io.keys_out = nullptr;
  io.perm_out = static_cast<int32_t*>(perm);
  io.act_out = inact ? static_cast<uint8_t*>(s_act) : nullptr;
  int err = dbt::radix_sort(io, sched, npasses, n, static_cast<uint32_t*>(scratch), st);
  if (err) return err;
  return dbt::gather_extras(io.perm_out, n, extra_in, extra_out, nextra, gather_packed,
                            dbt::radix_key_buffers(static_cast<uint32_t*>(scratch), n, npasses),
                            st);
}
