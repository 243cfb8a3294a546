// K10: build multiplicity of query keys, batched over cell pairs.
//
// Replaces the JAX package's member_multiplicity (ops/hash_join.py:256-345)
// and its batched use by the tiled join (jax.vmap inside lax.scan,
// ops/hash_join.py:459-469): for each of G cell pairs, every live query row
// gets the number of live build rows of its cell with the same m-word key;
// dead query rows get 0.  The JAX form sorts build ++ query per cell and
// runs two scans; any exact method gives the same counts.
//
// Design: one thread block a cell pair and an open-addressing table with
// linear probing.  A slot holds the index of the first build row that
// claimed it (atomicCAS) and the number of live build rows with that row's
// key (atomicAdd); keys are compared by reading the build cell's words, so
// a slot is 8 bytes whatever the key width (1 word or num + 32 string
// words).  After a barrier each live query row probes until it meets its
// key or an empty slot.  The build rows need no order.  The table has
// next_pow2(4/3 * cap_b) slots, at least a quarter of them empty, so every
// probe ends.  It lives in shared memory while it fits (slots <= 16384:
// cells of up to 12288 build rows, 128 KB, opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize); larger cells (capacities
// doubled by the overflow retry, or one whole table as a single cell) run
// the same kernel on a table in global scratch.
//
// Bound on the H100: bytes.  Per pair it reads cap_b + cap_k rows of m
// words and the two counts and writes cap_k counts.
#include "common.cuh"

namespace {

constexpr int MM_THREADS = 1024;
constexpr int64_t MM_SHARED_SLOTS = 16384;  // 8 B a slot: 128 KB of the 227 KB a block may use
constexpr int32_t MM_EMPTY = -1;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// murmur3 over the key words: independent of K8's hash, whose low bits are
// the same for every key of one cell
__device__ __forceinline__ uint32_t table_hash(const dbt::KeyCols& c, int64_t row) {
  uint32_t h = 0x9747B28Cu;
  for (int k = 0; k < c.count; ++k) {
    uint32_t w = c.ptr[k][row * c.stride[k]];
    w *= 0xCC9E2D51u;
    w = rotl32(w, 15);
    w *= 0x1B873593u;
    h ^= w;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool keys_equal(const dbt::KeyCols& a, int64_t ra,
                                           const dbt::KeyCols& b, int64_t rb) {
  for (int k = 0; k < a.count; ++k) {
    if (a.ptr[k][ra * a.stride[k]] != b.ptr[k][rb * b.stride[k]]) return false;
  }
  return true;
}

template <bool SHARED>
__global__ void __launch_bounds__(MM_THREADS)
member_mult_kernel(dbt::KeyCols bw, dbt::KeyCols kw, int64_t cap_b, int64_t cap_k,
                   const int32_t* n_bkeys, const int32_t* n_kkeys, const uint8_t* live_k,
                   uint32_t* out, int32_t* gtable, uint32_t slots) {
  extern __shared__ int32_t s_table[];
  const int64_t g = blockIdx.x;
  int32_t* table = SHARED ? s_table : gtable + g * 2 * (int64_t)slots;
  uint32_t* count = reinterpret_cast<uint32_t*>(table + slots);
  const uint32_t mask = slots - 1u;
  for (uint32_t s = threadIdx.x; s < slots; s += blockDim.x) {
    table[s] = MM_EMPTY;
    count[s] = 0u;
  }
  __syncthreads();

  int64_t nb = n_bkeys[g];
  nb = nb < 0 ? 0 : (nb > cap_b ? cap_b : nb);
  const int64_t b0 = g * cap_b;
  for (int64_t i = threadIdx.x; i < nb; i += blockDim.x) {
    uint32_t s = table_hash(bw, b0 + i) & mask;
    while (true) {
      int32_t cur = table[s];
      if (cur == MM_EMPTY) {
        cur = atomicCAS(&table[s], MM_EMPTY, (int32_t)i);
        if (cur == MM_EMPTY) cur = (int32_t)i;  // this row is the slot's key now
      }
      if (cur == (int32_t)i || keys_equal(bw, b0 + cur, bw, b0 + i)) {
        atomicAdd(&count[s], 1u);
        break;
      }
      s = (s + 1u) & mask;
    }
  }
  __syncthreads();

  int64_t nk = n_kkeys ? (int64_t)n_kkeys[g] : cap_k;
  nk = nk < 0 ? 0 : (nk > cap_k ? cap_k : nk);
  const int64_t k0 = g * cap_k;
  for (int64_t j = threadIdx.x; j < cap_k; j += blockDim.x) {
    uint32_t found = 0u;
    if (j < nk && (!live_k || live_k[k0 + j])) {
      uint32_t s = table_hash(kw, k0 + j) & mask;
      while (true) {
        const int32_t cur = table[s];
        if (cur == MM_EMPTY) break;
        if (keys_equal(bw, b0 + cur, kw, k0 + j)) {
          found = count[s];
          break;
        }
        s = (s + 1u) & mask;
      }
    }
    out[k0 + j] = found;
  }
}

uint32_t table_slots(int64_t cap_b) {
  const int64_t want = (4 * cap_b + 2) / 3;
  uint32_t s = 64;
  while ((int64_t)s < want) s <<= 1;
  return s;
}

}  // namespace

// words of the global table the kernel needs for G pairs (0: it is in shared memory)
DBT_API int64_t dbt_member_mult_scratch_words(int64_t G, int64_t cap_b) {
  const uint32_t slots = table_slots(cap_b);
  return slots <= MM_SHARED_SLOTS ? 0 : 2 * (int64_t)slots * G;
}

// bwords, kwords: m device pointers each (host arrays) to u32 columns of
// G * cap_b and G * cap_k rows (pair g owns rows [g * cap, (g + 1) * cap)),
// with their row strides.  n_bkeys i32[G]: the live build rows of each pair
// are its first n_bkeys[g].  A query row j of pair g is live when
// j < n_kkeys[g] (n_kkeys i32[G] or null) and live_k[g * cap_k + j] (u8 or
// null).  out u32[G * cap_k].
DBT_API int dbt_member_mult(const void* const* bwords, const int64_t* bstrides,
                            const void* const* kwords, const int64_t* kstrides, int m, int64_t G,
                            int64_t cap_b, int64_t cap_k, const void* n_bkeys,
                            const void* n_kkeys, const void* live_k, void* out, void* scratch,
                            void* stream) {
  if (m < 1 || m > dbt::MAX_KEY_WORDS || cap_b < 0 || cap_k < 0) return (int)cudaErrorInvalidValue;
  if (cap_b >= ((int64_t)1 << 30) || G >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (G <= 0 || cap_k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dbt::KeyCols bw = dbt::key_cols(bwords, bstrides, m);
  const dbt::KeyCols kw = dbt::key_cols(kwords, kstrides, m);
  const uint32_t slots = table_slots(cap_b);
  const int32_t* nb = static_cast<const int32_t*>(n_bkeys);
  const int32_t* nk = static_cast<const int32_t*>(n_kkeys);
  const uint8_t* lk = static_cast<const uint8_t*>(live_k);
  if (slots <= MM_SHARED_SLOTS) {
    const int bytes = (int)(slots * 8u);
    cudaError_t e = cudaFuncSetAttribute(member_mult_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    member_mult_kernel<true><<<(unsigned)G, MM_THREADS, bytes, st>>>(
        bw, kw, cap_b, cap_k, nb, nk, lk, static_cast<uint32_t*>(out), nullptr, slots);
  } else {
    member_mult_kernel<false><<<(unsigned)G, MM_THREADS, 0, st>>>(
        bw, kw, cap_b, cap_k, nb, nk, lk, static_cast<uint32_t*>(out),
        static_cast<int32_t*>(scratch), slots);
  }
  DBT_CHECK_LAUNCH();
  return 0;
}
