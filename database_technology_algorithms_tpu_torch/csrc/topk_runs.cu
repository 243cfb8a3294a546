// K19: the top-k runs of a sorted hash column.
//
// Replaces the run counts and the lax.top_k of the JAX package's
// local_topk_hashes (parallel/skew.py:44-65).  The input is the masked
// hashes sorted unsigned (K5; the dead rows hold 0xFFFFFFFF and sort last)
// and the number of active rows, nact, on the device.  Position i starts a
// run where i < nact and hs[i] differs from hs[i - 1]; its count is the
// run's length within [0, nact); every other position counts 0.  The output
// is the k positions of largest count in lax.top_k's order: count
// descending, the lower position first on ties, so that with fewer than k
// runs the zero-count positions follow, lowest first, and hs[top_pos]
// repeats hashes exactly as the JAX arrays do.
//
// Bound on the H100: bytes, one read of the sorted column (4 B a row).  A
// Zipf-hot run spans many tiles, so a run's count is not summed tile by tile:
// the thread at a run's start finds the run's end by a binary search in the
// sorted, active prefix (log2(nact) reads, the first levels shared by every
// search and held in L2).  Each position becomes one 64-bit key, (count << 32)
// | ~position, whose maximum is lax.top_k's first pick, and keys are unique.
// Pass 1: a block owns TILE positions, 16 a thread in registers, and takes
// its k largest keys by k block-wide max reductions, each winner cleared in
// the thread that held it.  Pass 2: one block takes the k largest of the
// blocks' k winners the same way, from global scratch, and writes the hash
// at each winner's position and its count.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr int TILE = THREADS * PER_THREAD;  // kernels/dist_plan.py TOPK_TILE
constexpr int MERGE_THREADS = 1024;

__device__ __forceinline__ uint64_t run_key(const uint32_t* __restrict__ hs, int32_t i,
                                            int32_t n, int32_t nact) {
  if (i >= n) return 0ull;  // no position: below every key
  uint32_t cnt = 0u;
  if (i < nact) {
    const uint32_t h = __ldg(hs + i);
    if (i == 0 || __ldg(hs + i - 1) != h) {
      int32_t lo = i + 1, hi = nact;  // the first position past the run
      while (lo < hi) {
        const int32_t mid = lo + ((hi - lo) >> 1);
        if (__ldg(hs + mid) == h)
          lo = mid + 1;
        else
          hi = mid;
      }
      cnt = (uint32_t)(lo - i);
    }
  }
  return ((uint64_t)cnt << 32) | (uint64_t)(~(uint32_t)i);
}

// The block's largest of each thread's `v`; every thread gets it.
template <int NT>
__device__ __forceinline__ uint64_t block_max(uint64_t v, uint64_t* s_warp) {
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(dbt::FULL_MASK, v, off);
    v = o > v ? o : v;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // s_warp is free: the previous round has read it
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  uint64_t m = 0ull;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) m = s_warp[w] > m ? s_warp[w] : m;
  return m;
}

__global__ void __launch_bounds__(THREADS)
    topk_tiles(const uint32_t* __restrict__ hs, int32_t n, const int32_t* __restrict__ nact_dev,
               int k, uint64_t* __restrict__ winners) {
  __shared__ uint64_t s_warp[THREADS / 32];
  int32_t nact = *nact_dev;
  nact = nact < 0 ? 0 : (nact > n ? n : nact);
  const int64_t t0 = (int64_t)blockIdx.x * TILE;
  uint64_t key[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int64_t i = t0 + u * THREADS + threadIdx.x;
    key[u] = i < n ? run_key(hs, (int32_t)i, n, nact) : 0ull;
  }
  for (int r = 0; r < k; ++r) {
    uint64_t mine = 0ull;
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u) mine = key[u] > mine ? key[u] : mine;
    const uint64_t best = block_max<THREADS>(mine, s_warp);
#pragma unroll
    for (int u = 0; u < PER_THREAD; ++u)
      if (best != 0ull && key[u] == best) key[u] = 0ull;  // keys are unique
    if (threadIdx.x == 0) winners[(int64_t)blockIdx.x * k + r] = best;
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
    topk_merge(const uint32_t* __restrict__ hs, uint64_t* __restrict__ winners, int64_t m, int k,
               int32_t* __restrict__ top_hash, int32_t* __restrict__ top_count) {
  __shared__ uint64_t s_warp[MERGE_THREADS / 32];
  for (int r = 0; r < k; ++r) {
    uint64_t mine = 0ull;
    int64_t at = -1;
    for (int64_t j = threadIdx.x; j < m; j += MERGE_THREADS) {
      const uint64_t v = winners[j];
      if (v > mine) {
        mine = v;
        at = j;
      }
    }
    const uint64_t best = block_max<MERGE_THREADS>(mine, s_warp);
    if (at >= 0 && mine == best) winners[at] = 0ull;  // one thread holds it
    if (threadIdx.x == 0) {
      const uint32_t pos = ~(uint32_t)(best & 0xFFFFFFFFull);
      top_hash[r] = (int32_t)__ldg(hs + pos);
      top_count[r] = (int32_t)(best >> 32);
    }
    __syncthreads();  // the cleared winner is seen by the next round's reads
  }
}

}  // namespace

DBT_API int64_t dbt_topk_runs_scratch_words(int64_t n, int k) {
  const int64_t tiles = n > 0 ? (n + TILE - 1) / TILE : 1;
  return 2 * tiles * (int64_t)k;  // a 64-bit key per tile and round
}

// hs u32[n], sorted unsigned over its first nact rows (nact: one i32 on the
// device); 1 <= k <= n; top_hash i32[k], top_count i32[k]; scratch of
// dbt_topk_runs_scratch_words(n, k) 32-bit words, 8-byte aligned.
DBT_API int dbt_topk_runs(const void* hs, int64_t n, const void* nact, int k, void* top_hash,
                          void* top_count, void* scratch, int64_t scratch_words, void* stream) {
  if (n < 1 || n > INT32_MAX || k < 1 || k > n ||
      scratch_words < dbt_topk_runs_scratch_words(n, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + TILE - 1) / TILE;
  uint64_t* winners = static_cast<uint64_t*>(scratch);
  topk_tiles<<<(unsigned)tiles, THREADS, 0, st>>>(static_cast<const uint32_t*>(hs), (int32_t)n,
                                                  static_cast<const int32_t*>(nact), k, winners);
  DBT_CHECK_LAUNCH();
  topk_merge<<<1, MERGE_THREADS, 0, st>>>(static_cast<const uint32_t*>(hs), winners, tiles * k, k,
                                          static_cast<int32_t*>(top_hash),
                                          static_cast<int32_t*>(top_count));
  DBT_CHECK_LAUNCH();
  return 0;
}
