// K16 and K17: the open-addressing hash set of u32 keys, its build and its
// probe.
//
// Replaces the JAX package's build_hash_set (ops/hash_table.py:50-105) and
// probe_hash_set (ops/hash_table.py:108-146): a power-of-two table of
// _mix(key) values with linear probing, filled by parallel insertion and
// probed by hash, read and compare.
//
// Bound on the H100: bytes and latency.  A build key is read once and costs
// one atomicCAS a slot it visits; a probe key one 4-byte read a slot.  At
// the path's sizes the table is 8 MB (1M build keys, 2^21 slots) and in the
// 50 MB L2, or 64 MB (8M, 2^24 slots) and not.  One thread a key.
//
// Exactness, which the JAX form does not have (it stores the one key whose
// mix is EMPTY as EMPTY ^ 1, the mix of another key, and probes fewer slots
// than it inserts into when hash_max_probe < 64):
//  - the key whose mix is EMPTY is never stored; the build sets a flag word,
//    and the probe of that key reads the flag;
//  - the build gives up on a key after `limit` slots, where the caller sets
//    limit = min(64, hash_max_probe), and counts it as failed; the caller
//    then takes the exact fallback.  A stored key sits within limit slots of
//    its home, and no slot between is EMPTY (slots are never emptied), so
//    the probe, which walks up to hash_max_probe >= limit slots and stops at
//    EMPTY, finds every stored key.
// The table's layout depends on the order of the atomics; the set it holds
// does not while no key fails.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr uint32_t EMPTY = 0xFFFFFFFFu;

// murmur3's finalizer, bijective on u32 (ops/hash_table.py:34)
__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// meta[0]: the EMPTY-key flag; meta[1]: keys that failed
__global__ void __launch_bounds__(THREADS)
    hash_set_build_kernel(const uint32_t* __restrict__ keys, int32_t n,
                          const int32_t* __restrict__ cnt_dev, int32_t cnt_host,
                          uint32_t* __restrict__ table, uint32_t mask, int limit,
                          int32_t* __restrict__ meta) {
  const int32_t i = (int32_t)(blockIdx.x * THREADS + threadIdx.x);
  if (i >= n || i >= (cnt_dev ? *cnt_dev : cnt_host)) return;
  const uint32_t h = mix(keys[i]);
  if (h == EMPTY) {
    meta[0] = 1;  // every such thread writes the same value
    return;
  }
  uint32_t slot = h & mask;
  for (int d = 0; d < limit; ++d) {
    // a slot once written never changes, so a read that sees another key is
    // final; one that sees EMPTY is settled by the CAS
    uint32_t cur = __ldcg(table + slot);
    if (cur == EMPTY) cur = atomicCAS(table + slot, EMPTY, h);
    if (cur == EMPTY || cur == h) return;
    slot = (slot + 1) & mask;
  }
  atomicAdd(meta + 1, 1);
}

__global__ void __launch_bounds__(THREADS)
    hash_set_probe_kernel(const uint32_t* __restrict__ table, uint32_t mask,
                          const int32_t* __restrict__ meta, const uint32_t* __restrict__ keys,
                          int32_t n, const int32_t* __restrict__ cnt_dev, int32_t cnt_host,
                          int max_probe, bool* __restrict__ found, int32_t* __restrict__ mult) {
  const int32_t i = (int32_t)(blockIdx.x * THREADS + threadIdx.x);
  if (i >= n) return;
  bool f = false;
  if (i < (cnt_dev ? *cnt_dev : cnt_host)) {
    const uint32_t q = mix(keys[i]);
    if (q == EMPTY) {
      f = meta[0] != 0;
    } else {
      uint32_t slot = q & mask;
      for (int d = 0; d < max_probe; ++d) {
        const uint32_t cur = __ldg(table + slot);
        if (cur == q) {
          f = true;
          break;
        }
        if (cur == EMPTY) break;
        slot = (slot + 1) & mask;
      }
    }
  }
  found[i] = f;
  mult[i] = f ? 1 : 0;
}

}  // namespace

// keys u32[n] (the first count live: cnt one i32 on the device, or null and
// cnt_host); table u32[size], size a power of two; meta i32[2].  Fills the
// table with EMPTY and meta with 0, then inserts.
DBT_API int dbt_hash_set_build(const void* keys, int64_t n, const void* cnt, int64_t cnt_host,
                               void* table, int64_t size, int limit, void* meta, void* stream) {
  if (n < 0 || n > INT32_MAX || size < 1 || size > (int64_t(1) << 31) || (size & (size - 1)) ||
      limit < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(table, 0xFF, size * sizeof(uint32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(meta, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  hash_set_build_kernel<<<dbt::blocks_for(n, THREADS), THREADS, 0, s>>>(
      static_cast<const uint32_t*>(keys), (int32_t)n, static_cast<const int32_t*>(cnt),
      (int32_t)cnt_host, static_cast<uint32_t*>(table), (uint32_t)(size - 1), limit,
      static_cast<int32_t*>(meta));
  DBT_CHECK_LAUNCH();
  return 0;
}

// table u32[size] and meta i32[2] from dbt_hash_set_build; keys u32[n] with
// their live count as above; found bool[n], mult i32[n].
DBT_API int dbt_hash_set_probe(const void* table, int64_t size, const void* meta, const void* keys,
                               int64_t n, const void* cnt, int64_t cnt_host, int max_probe,
                               void* found, void* mult, void* stream) {
  if (n < 0 || n > INT32_MAX || size < 1 || size > (int64_t(1) << 31) || (size & (size - 1)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  hash_set_probe_kernel<<<dbt::blocks_for(n, THREADS), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), (uint32_t)(size - 1),
      static_cast<const int32_t*>(meta), static_cast<const uint32_t*>(keys), (int32_t)n,
      static_cast<const int32_t*>(cnt), (int32_t)cnt_host, max_probe < 0 ? 0 : max_probe,
      static_cast<bool*>(found), static_cast<int32_t*>(mult));
  DBT_CHECK_LAUNCH();
  return 0;
}
