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
// inact per row and writes perm (4 B) and s_act (1 B).  The design is a
// stable LSD radix sort of the row index alone: 8-bit passes from the last
// word's low byte up to the first word's high byte, then one pass on the
// inact bit, 4m + 1 passes of radix.cuh.  No key moves: each pass reads its
// digit as word[perm[i] * stride], through the order so far, so a column of
// a row-major [N, K] matrix is sorted where it lies.  The price is one
// random 4-byte read per row and pass; at the pipeline's sizes the key
// columns fit the 50 MB L2 cache.  Stability across tiles (a long run of
// equal keys spans many tiles) comes from the digit-major scan of per-tile
// counts, as in K1.
#include "radix.cuh"

DBT_API int64_t dbt_words_sort_scratch_words(int64_t n) {
  return 2 * n + dbt::radix_scratch_words(n);
}

// words: m device pointers (host array) to u32 columns of n rows, the row
// stride of each in `strides` (host array, in words); inact u8[n] or null
// (every row active; s_act is then left untouched).  perm i32[n], s_act
// u8[n]; extra_out[j][i] = extra_in[j][perm[i]].
DBT_API int dbt_words_sort(const void* const* words, const int64_t* strides, int m,
                           const void* inact, int64_t n, void* perm, void* s_act,
                           const void* const* extra_in, void* const* extra_out, int nextra,
                           void* scratch, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* in_act = static_cast<const uint8_t*>(inact);
  int32_t* out = static_cast<int32_t*>(perm);
  int32_t* bufs[2] = {static_cast<int32_t*>(scratch), static_cast<int32_t*>(scratch) + n};
  const dbt::RadixScratch rs =
      dbt::radix_scratch(reinterpret_cast<uint32_t*>(bufs[1] + n), n);

  const int passes = 4 * m + (in_act ? 1 : 0);
  const int32_t* vin = nullptr;  // pass 0 makes the row index
  int t = 0;
  for (int w = m - 1; w >= 0; --w) {
    const uint32_t* col = static_cast<const uint32_t*>(words[w]);
    for (int d = 0; d < 4; ++d, ++t) {
      int32_t* vout = t == passes - 1 ? out : bufs[t & 1];
      int err = dbt::radix_pass<dbt::DIGIT_GATHER>(col, strides[w], vin, nullptr, nullptr, vout,
                                                   nullptr, n, 8 * d, rs, st);
      if (err) return err;
      vin = vout;
    }
  }
  if (in_act) {
    // most significant: the inactive bit (actives first)
    int err = dbt::radix_pass<dbt::DIGIT_INACT>(nullptr, 1, vin, in_act, nullptr, out,
                                                static_cast<uint8_t*>(s_act), n, 0, rs, st);
    if (err) return err;
  }
  return dbt::gather_extras(out, n, extra_in, extra_out, nextra, st);
}
