// K10: build multiplicity of query keys, batched over cell pairs.
//
// Replaces the JAX package's member_multiplicity (ops/hash_join.py:256-345)
// and its batched use by the tiled join (jax.vmap inside lax.scan,
// ops/hash_join.py:459-469): for each of G cell pairs, every live query row
// gets the number of live build rows of its cell with the same m-word key;
// dead query rows get 0.  The JAX form sorts build ++ query per cell and
// runs two scans; any exact method gives the same counts.
//
// Design (kernels/cells_plan.py): one thread block a cell pair and an
// open-addressing table, sized on the card from the
// pair's live build rows: next_pow2(4/3 * n_bkeys[g]) slots, at least 64, so
// that a quarter stay empty and every probe ends.  The table lives in the
// launch's shared memory where it fits the plan's `shared` slots (chosen by
// the plan from cap_b and the key width), else in global scratch: a skewed
// pair, or the capacities doubled by the overflow retry, take the same code
// on a table in memory, decided per block.
//   one word   a slot is one 64-bit word, (count << 32) | key, 0 when empty:
//              a build row claims it as (1, key) by a 64-bit atomicCAS, and a
//              row whose key holds it adds one to its high word (a 32-bit
//              atomicAdd), so no compare leaves shared memory;
//   m words    a slot is (32-bit hash << 32) | (build row + 1) beside a
//              32-bit count; the build row's words are read from global
//              memory only where the hash matches.
// Probes step 1, 2, 3, ... slots on (triangular numbers, which visit every
// slot of a power-of-two table): linear probing's clusters at a load near
// 3/4 left each warp waiting for its longest chain.  The build rows need no
// order.  After a barrier each live query row probes until it meets its key
// or an empty slot; query rows are read and `out`
// written in row order, each thread loading its rows before it uses any.
// With `out_pos` the live query rows of pair g go to out[out_pos[g] + j]
// (the occupied slots of every pair, compacted) and rows past n_kkeys[g]
// are not written.
//
// Bound on the H100: bytes.  Per pair it reads the live build rows' and the
// query rows' m words and the two counts, and writes a count a query slot.
#include "common.cuh"

namespace {

constexpr int MM_MAX_THREADS = 1024;
constexpr int MM_UNROLL = 4;  // rows a thread loads before it uses any
constexpr uint32_t MM_MIN_SLOTS = 64;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// murmur3 over the key words: independent of K8's hash, whose low bits are
// the same for every key of one cell
__device__ __forceinline__ uint32_t mix_word(uint32_t h, uint32_t w) {
  w *= 0xCC9E2D51u;
  w = rotl32(w, 15);
  w *= 0x1B873593u;
  h ^= w;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr uint32_t MM_SEED = 0x9747B28Cu;

__device__ __forceinline__ uint32_t table_hash(const dbt::KeyCols& c, int64_t row) {
  uint32_t h = MM_SEED;
  for (int k = 0; k < c.count; ++k) h = mix_word(h, c.ptr[k][row * c.stride[k]]);
  return fmix(h);
}

__device__ __forceinline__ bool keys_equal(const dbt::KeyCols& a, int64_t ra,
                                           const dbt::KeyCols& b, int64_t rb) {
  for (int k = 0; k < a.count; ++k) {
    if (a.ptr[k][ra * a.stride[k]] != b.ptr[k][rb * b.stride[k]]) return false;
  }
  return true;
}

__device__ __forceinline__ uint32_t table_slots(int64_t live) {
  const int64_t want = (4 * live + 2) / 3;
  uint32_t s = MM_MIN_SLOTS;
  while ((int64_t)s < want) s <<= 1;
  return s;
}

// a table word: shared memory as it is, global memory from L2 (the atomics
// of other threads land there, not in this SM's L1)
template <bool SH>
__device__ __forceinline__ uint64_t peek(const uint64_t* p) {
  if (SH) return *p;
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

template <bool SH>
__device__ __forceinline__ uint32_t peek32(const uint32_t* p) {
  if (SH) return *p;
  return __ldcg(p);
}

struct MMArgs {
  dbt::KeyCols bw, kw;
  int64_t cap_b, cap_k;
  const int32_t* n_bkeys;
  const int32_t* n_kkeys;  // or null
  const uint8_t* live_k;   // or null
  uint32_t* out;
  const int32_t* out_pos;  // or null
  uint64_t* gtab;          // [G, gslots] slot words
  uint32_t* gcnt;          // [G, gslots] counts (m > 1)
  int64_t gslots;
  uint32_t shared_slots;
};

// One pair on a table of mask + 1 slots: in the launch's shared memory (SH,
// so that the compiler sees the address space and issues shared atomics) or
// at tab / cnt in global scratch.
template <bool ONE, bool SH>
__device__ __forceinline__ void run_pair(const MMArgs& a, int64_t g, int64_t nb, uint32_t mask,
                                         uint64_t* gtab, uint32_t* gcnt) {
  extern __shared__ uint64_t mm_shared[];
  uint64_t* tab = SH ? mm_shared : gtab;
  uint32_t* cnt = ONE ? nullptr : (SH ? reinterpret_cast<uint32_t*>(mm_shared + a.shared_slots)
                                      : gcnt);
  const int64_t bd = blockDim.x;
  for (uint32_t s = threadIdx.x; s <= mask; s += blockDim.x) {
    tab[s] = 0ull;
    if (!ONE) cnt[s] = 0u;
  }
  __syncthreads();

  const int64_t b0 = g * a.cap_b;
  for (int64_t base = 0; base < nb; base += bd * MM_UNROLL) {  // the same trips in every warp
    uint32_t key[MM_UNROLL];
#pragma unroll
    for (int u = 0; u < MM_UNROLL; ++u) {
      const int64_t i = base + threadIdx.x + u * bd;
      if (ONE) key[u] = i < nb ? a.bw.ptr[0][(b0 + i) * a.bw.stride[0]] : 0u;
      else key[u] = i < nb ? table_hash(a.bw, b0 + i) : 0u;
    }
#pragma unroll
    for (int u = 0; u < MM_UNROLL; ++u) {
      const int64_t i = base + threadIdx.x + u * bd;
      const bool in = i < nb;
      if (ONE) {
        if (!in) continue;
        // claim an empty slot as (1, key), or add one to the key's count,
        // the high word of the slot
        uint32_t s = fmix(mix_word(MM_SEED, key[u])) & mask, step = 0u;
        const uint64_t claim = (1ull << 32) | key[u];
        while (true) {
          uint64_t cur = peek<SH>(&tab[s]);
          if (cur == 0ull) {
            cur = atomicCAS(reinterpret_cast<unsigned long long*>(&tab[s]), 0ull, claim);
            if (cur == 0ull) break;
          }
          if ((uint32_t)cur == key[u]) {
            atomicAdd(reinterpret_cast<uint32_t*>(&tab[s]) + 1, 1u);
            break;
          }
          s = (s + ++step) & mask;
        }
      } else {
        if (!in) continue;
        const uint32_t h = key[u];
        const uint64_t tag = ((uint64_t)h << 32) | (uint64_t)(i + 1);
        uint32_t s = h & mask, step = 0u;
        while (true) {
          uint64_t cur = peek<SH>(&tab[s]);
          if (cur == 0ull) {
            cur = atomicCAS(reinterpret_cast<unsigned long long*>(&tab[s]), 0ull, tag);
            if (cur == 0ull) {
              atomicAdd(&cnt[s], 1u);
              break;
            }
          }
          if ((uint32_t)(cur >> 32) == h &&
              keys_equal(a.bw, b0 + (int64_t)(uint32_t)cur - 1, a.bw, b0 + i)) {
            atomicAdd(&cnt[s], 1u);
            break;
          }
          s = (s + ++step) & mask;
        }
      }
    }
  }
  __syncthreads();

  int64_t nk = a.n_kkeys ? (int64_t)a.n_kkeys[g] : a.cap_k;
  nk = nk < 0 ? 0 : (nk > a.cap_k ? a.cap_k : nk);
  const int64_t k0 = g * a.cap_k;
  const int64_t rows = a.out_pos ? nk : a.cap_k;  // the rows this pair writes
  uint32_t* dst = a.out + (a.out_pos ? (int64_t)a.out_pos[g] : k0);
  for (int64_t base = threadIdx.x; base < rows; base += bd * MM_UNROLL) {
    uint32_t key[MM_UNROLL];
    bool live[MM_UNROLL];
#pragma unroll
    for (int u = 0; u < MM_UNROLL; ++u) {
      const int64_t j = base + u * bd;
      live[u] = j < nk && (!a.live_k || a.live_k[k0 + j]);
      if (ONE) key[u] = live[u] ? a.kw.ptr[0][(k0 + j) * a.kw.stride[0]] : 0u;
      else key[u] = live[u] ? table_hash(a.kw, k0 + j) : 0u;
    }
#pragma unroll
    for (int u = 0; u < MM_UNROLL; ++u) {
      const int64_t j = base + u * bd;
      if (j >= rows) break;
      uint32_t found = 0u;
      if (live[u]) {
        uint32_t s = (ONE ? fmix(mix_word(MM_SEED, key[u])) : key[u]) & mask, step = 0u;
        while (true) {
          const uint64_t cur = peek<SH>(&tab[s]);
          if (cur == 0ull) break;
          if (ONE) {
            if ((uint32_t)cur == key[u]) {
              found = (uint32_t)(cur >> 32);
              break;
            }
          } else if ((uint32_t)(cur >> 32) == key[u] &&
                     keys_equal(a.bw, b0 + (int64_t)(uint32_t)cur - 1, a.kw, k0 + j)) {
            found = peek32<SH>(&cnt[s]);
            break;
          }
          s = (s + ++step) & mask;
        }
      }
      dst[j] = found;
    }
  }
}

template <bool ONE>
__global__ void __launch_bounds__(MM_MAX_THREADS) member_mult_kernel(MMArgs a) {
  const int64_t g = blockIdx.x;
  int64_t nb = a.n_bkeys[g];
  nb = nb < 0 ? 0 : (nb > a.cap_b ? a.cap_b : nb);
  const uint32_t slots = table_slots(nb);
  if (slots <= a.shared_slots) {
    run_pair<ONE, true>(a, g, nb, slots - 1u, nullptr, nullptr);
  } else {
    run_pair<ONE, false>(a, g, nb, slots - 1u, a.gtab + g * a.gslots,
                         ONE ? nullptr : a.gcnt + g * a.gslots);
  }
}

int64_t host_table_slots(int64_t live) {
  const int64_t want = (4 * live + 2) / 3;
  int64_t s = MM_MIN_SLOTS;
  while (s < want) s <<= 1;
  return s;
}

}  // namespace

// bwords, kwords: m device pointers each (host arrays) to u32 columns of
// G * cap_b and G * cap_k rows (pair g owns rows [g * cap, (g + 1) * cap)),
// with their row strides.  n_bkeys i32[G]: the live build rows of each pair
// are its first n_bkeys[g].  A query row j of pair g is live when
// j < n_kkeys[g] (n_kkeys i32[G] or null) and live_k[g * cap_k + j] (u8 or
// null).  out u32[G * cap_k], or with out_pos (i32[G]) the rows j <
// n_kkeys[g] of pair g at out[out_pos[g] + j].  `shared_slots`: the shared
// table's slots (a power of two); scratch: the global tables, G tables of
// table_slots(cap_b) slots where that is above shared_slots (8 bytes a slot,
// and 4 more for m > 1).  `threads` a block.
DBT_API int dbt_member_mult(const void* const* bwords, const int64_t* bstrides,
                            const void* const* kwords, const int64_t* kstrides, int m, int64_t G,
                            int64_t cap_b, int64_t cap_k, const void* n_bkeys,
                            const void* n_kkeys, const void* live_k, void* out,
                            const void* out_pos, void* scratch, int64_t scratch_words,
                            int64_t shared_slots, int threads, void* stream) {
  if (m < 1 || m > dbt::MAX_KEY_WORDS || cap_b < 0 || cap_k < 0) return (int)cudaErrorInvalidValue;
  if (cap_b >= ((int64_t)1 << 30) || G >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  if (threads < 32 || threads > MM_MAX_THREADS || threads % 32 != 0 ||
      shared_slots < MM_MIN_SLOTS || (shared_slots & (shared_slots - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (G <= 0 || cap_k == 0) return 0;
  const int64_t slot_bytes = m == 1 ? 8 : 12;
  const int64_t gslots = host_table_slots(cap_b);
  const int64_t gwords = gslots <= shared_slots ? 0 : G * gslots * slot_bytes / 4;
  const size_t bytes = (size_t)(shared_slots * slot_bytes);
  if (scratch_words < gwords || bytes > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MMArgs a;
  a.bw = dbt::key_cols(bwords, bstrides, m);
  a.kw = dbt::key_cols(kwords, kstrides, m);
  a.cap_b = cap_b;
  a.cap_k = cap_k;
  a.n_bkeys = static_cast<const int32_t*>(n_bkeys);
  a.n_kkeys = static_cast<const int32_t*>(n_kkeys);
  a.live_k = static_cast<const uint8_t*>(live_k);
  a.out = static_cast<uint32_t*>(out);
  a.out_pos = static_cast<const int32_t*>(out_pos);
  a.gtab = static_cast<uint64_t*>(scratch);
  a.gcnt = gwords ? reinterpret_cast<uint32_t*>(a.gtab + G * gslots) : nullptr;
  a.gslots = gslots;
  a.shared_slots = (uint32_t)shared_slots;
  const void* kernel = m == 1 ? (const void*)member_mult_kernel<true>
                              : (const void*)member_mult_kernel<false>;
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  if (m == 1) member_mult_kernel<true><<<(unsigned)G, threads, bytes, st>>>(a);
  else member_mult_kernel<false><<<(unsigned)G, threads, bytes, st>>>(a);
  DBT_CHECK_LAUNCH();
  return 0;
}
