// K3: stable compaction.
//
// Replaces the JAX package's compact_words (ops/movement.py:479), a 2-key
// lax.sort of (drop, row) carrying the payload words: kept rows first, in
// order, then the dropped rows, in order.
//
// Bound on the H100: bytes.  Per row it reads the 1-byte keep flag and
// 4 bytes per payload word, and writes 4 bytes per payload word.  A sort is
// not needed for a two-valued key: the wrapper takes the inclusive count of
// kept rows from K2 (seg_scan.cu, a plain add scan), and this kernel moves
// every word in one scatter, row i to  keep ? incl[i]-1 : cnt + (i-incl[i]),
// with cnt = incl[n-1] read on the device, so the host never waits.
// Up to eight words move per launch (WordPtrs), one thread per row.
#include "common.cuh"

namespace {

__global__ void compact_scatter(const uint8_t* keep, const uint32_t* incl, int64_t n,
                                dbt::WordPtrs w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t cnt = incl[n - 1];
  const int64_t r = incl[i];
  const int64_t dst = keep[i] ? r - 1 : cnt + (i - r);
  for (int k = 0; k < w.count; ++k) w.dst[k][dst] = w.src[k][i];
}

}  // namespace

// keep u8[n], incl u32[n] (inclusive count of kept rows); src/dst: nwords
// u32[n] columns each.
DBT_API int dbt_compact_scatter(const void* keep, const void* incl, int64_t n,
                                const void* const* src, void* const* dst, int nwords,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int first = 0; first < nwords; first += dbt::MAX_WORDS) {
    const int cnt = nwords - first < dbt::MAX_WORDS ? nwords - first : dbt::MAX_WORDS;
    compact_scatter<<<dbt::blocks_for(n, 256), 256, 0, st>>>(
        static_cast<const uint8_t*>(keep), static_cast<const uint32_t*>(incl), n,
        dbt::word_ptrs(src, dst, first, cnt));
    DBT_CHECK_LAUNCH();
  }
  return 0;
}
