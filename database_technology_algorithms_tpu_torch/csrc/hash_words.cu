// K8: the key hash.
//
// Replaces the JAX package's hash_words (ops/keys.py:110-143): FNV-1a over
// the four bytes of each of m u32 key words, low byte first, starting from a
// seeded basis, then the murmur3 finalizer for avalanche.  From word index
// skip_from on, a word that is zero is skipped: NUL-normalized string words
// are zero only past the terminator, so a string key hashes the same
// whether it is stored in 2 or in 32 words.  Words before skip_from (the
// num word of the (num, str) key, where 0 is a legal value) always hash.
//
// Bound on the H100: bytes.  Per row it reads m words and writes one.  One
// thread a row reads the words at their strides (a column of the row-major
// string matrix is read where it lies, as K5 and K6 read it) and keeps the
// running hash in a register; all arithmetic is uint32_t, so the multiplies
// wrap and the shifts are logical by construction.  The modulo by the number
// of cells stays with the caller.
#include "common.cuh"

namespace {

constexpr uint32_t FNV_PRIME = 16777619u;

__global__ void hash_words_kernel(dbt::KeyCols c, int64_t n, uint32_t basis, int skip_from,
                                  uint32_t* out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h = basis;
  for (int k = 0; k < c.count; ++k) {
    const uint32_t w = c.ptr[k][i * c.stride[k]];
    if (k >= skip_from && w == 0u) continue;
    h = (h ^ (w & 0xFFu)) * FNV_PRIME;
    h = (h ^ ((w >> 8) & 0xFFu)) * FNV_PRIME;
    h = (h ^ ((w >> 16) & 0xFFu)) * FNV_PRIME;
    h = (h ^ (w >> 24)) * FNV_PRIME;
  }
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  out[i] = h;
}

}  // namespace

// words: m device pointers (host array) to u32 columns of n rows, the row
// stride of each in `strides` (host array, in words).  basis is the seeded
// FNV basis; skip_from >= m disables the zero-word skip.  out u32[n].
DBT_API int dbt_hash_words(const void* const* words, const int64_t* strides, int m, int64_t n,
                           uint32_t basis, int skip_from, void* out, void* stream) {
  if (m < 1 || m > dbt::MAX_KEY_WORDS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  hash_words_kernel<<<dbt::blocks_for(n, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      dbt::key_cols(words, strides, m), n, basis, skip_from, static_cast<uint32_t*>(out));
  DBT_CHECK_LAUNCH();
  return 0;
}
