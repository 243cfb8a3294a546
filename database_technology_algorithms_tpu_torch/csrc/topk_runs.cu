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
// repeats hashes exactly as the JAX arrays do.  Each position becomes one
// 64-bit key, (count << 32) | ~position: its maximum is lax.top_k's first
// pick, and keys are unique (no position: 0, below every key).
//
// Bound on the H100: bytes, one read of the sorted column (4 B a row).  One
// launch; a block owns a tile of TILE positions, a warp 512 consecutive ones
// (CHUNKS steps of 32, one position a lane, coalesced, all loads issued
// before any is used).
// - Run lengths without a search a start: a ballot a step gives the warp's
//   start flags; a run's end is the next start (the same step, a later step,
//   the first start of a later warp of the tile from shared memory, in that
//   order: a reverse scan of the flags) or nact.  Only the tile's last run,
//   which may cross into later tiles, looks ahead: the 32 positions past the
//   tile, then a 32-ary search of the sorted prefix (a probe a lane, about
//   log32(nact) steps).  A tile inside a Zipf-hot run reads each row once.
// - k <= 32 (SMALL): each warp keeps its k largest keys in registers, one a
//   lane, sorted across lanes: the first step's keys sorted by shuffles,
//   then a step's keys enter only where they beat the warp's k-th (a
//   ballot; each entrant a shuffle insert), so after the first steps almost
//   nothing enters.  The block merges its warps' lists in three levels of
//   pairs: the 32 largest of two sorted lists are the larger of A[j] and
//   B[31 - j], a bitonic sequence that five shuffle stages sort.
// - k > 32 (BIG, up to 1024): the block keeps its list in shared memory:
//   in rounds of BIG_ROUND keys a thread, keys that beat the list's k-th
//   are appended to a buffer behind it (a warp-aggregated atomic), and a
//   bitonic sort of list and buffer (the least power of 2 that holds them,
//   at most BIG_SORT keys) keeps the k largest after the first round and
//   whenever the next round could fill the buffer.
// - The merge: every block writes its k keys to scratch and counts itself
//   done on a counter that the entry zeroes on the stream; the last block
//   takes the k largest of all tiles' keys in one pass with the same
//   selection (its warps stream over the keys), entering only keys above
//   the largest of the tiles' k-th keys, and writes the hashes and counts.
//   No state outlives the launch.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 16;                  // 32-position steps a warp
constexpr int WARP_SPAN = 32 * CHUNKS;      // positions a warp
constexpr int TILE = WARPS * WARP_SPAN;     // kernels/dist_plan.py TOPK_TILE
constexpr int SMALL_K = 32;                 // kernels/dist_plan.py TOPK_WARP_K
constexpr int MAX_K = 1024;                 // kernels/dist_plan.py TOPK_MAX_K
constexpr int BIG_SORT = 4096;              // kernels/dist_plan.py TOPK_BIG_SORT
constexpr int BIG_ROUND = 4;                // keys a thread offers a round (TOPK_BIG_ROUND)
constexpr int32_t NO_START = INT32_MAX;

struct Args {
  const uint32_t* hs;
  int32_t n;
  const int32_t* nact;
  int k;
  unsigned* done;     // zeroed by the entry
  uint64_t* winners;  // [tiles * k]: each tile's k largest keys
  int32_t* top_hash;
  int32_t* top_count;
};

// The first q in [lo, nact] with q == nact or hs[q] != h, where hs[lo - 1]
// == h and hs is sorted over [0, nact): the next 32 positions, then a
// 32-ary search (lane L probes the end of the L-th of 32 equal parts).
// Every lane of the warp calls it and gets the answer.
__device__ int32_t run_end(const uint32_t* __restrict__ hs, int32_t lo, int32_t nact,
                           uint32_t h) {
  const int lane = threadIdx.x & 31;
  int64_t a = lo, b = nact;  // positions before a are in the run; b is past it
  {
    const int64_t q = a + lane;
    const unsigned past = __ballot_sync(dbt::FULL_MASK, q >= b || __ldg(hs + q) != h);
    if (past) return (int32_t)(a + __ffs(past) - 1);
    a += 32;
  }
  while (a < b) {
    const int64_t w = (b - a + 31) / 32;
    const int64_t q = a + (lane + 1) * w - 1;
    const unsigned past = __ballot_sync(dbt::FULL_MASK, q >= b || __ldg(hs + q) != h);
    if (!past) return (int32_t)b;  // every probe in the run, the last at b - 1
    const int f = __ffs(past) - 1;
    const int64_t qf = a + (f + 1) * w - 1;
    if (f > 0) a = a + f * w;  // the probe before f, plus one
    b = qf < b ? qf : b;
  }
  return (int32_t)a;
}

// The keys of the warp's CHUNKS steps: key[c] is the position at step c of
// this lane.  s_first[w] gets warp w's first run start (NO_START if none);
// every thread of the block must call it (one __syncthreads).
__device__ void tile_keys(const Args& a, int32_t nact, int64_t t0, uint64_t key[CHUNKS],
                          int32_t* s_first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w0 = t0 + (int64_t)warp * WARP_SPAN;
  uint32_t h[CHUNKS], m[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int64_t p = w0 + 32 * c + lane;
    h[c] = p < a.n ? __ldg(a.hs + p) : 0xFFFFFFFFu;
  }
  const uint32_t before = (w0 > 0 && w0 <= a.n) ? __ldg(a.hs + w0 - 1) : 0u;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    uint32_t prev = __shfl_up_sync(dbt::FULL_MASK, h[c], 1);
    const uint32_t carry = c > 0 ? __shfl_sync(dbt::FULL_MASK, h[c > 0 ? c - 1 : 0], 31) : before;
    if (lane == 0) prev = carry;
    const int64_t p = w0 + 32 * c + lane;
    m[c] = __ballot_sync(dbt::FULL_MASK, p < nact && (p == 0 || h[c] != prev));
  }
  int32_t first = NO_START;
#pragma unroll
  for (int c = CHUNKS - 1; c >= 0; --c)
    if (m[c]) first = (int32_t)(w0 + 32 * c + __ffs(m[c]) - 1);
  if (lane == 0) s_first[warp] = first;
  __syncthreads();
  // the first start past this warp's span: a later warp's, else past the tile
  int32_t after = NO_START;
  for (int v = WARPS - 1; v > warp; --v)
    if (s_first[v] != NO_START) after = s_first[v];
  if (after == NO_START && first != NO_START) {
    // this warp holds the tile's last run start: its run reaches the tile's
    // end or nact
    const int64_t te = min(t0 + (int64_t)TILE, (int64_t)a.n);
    after = te >= nact ? nact : run_end(a.hs, (int32_t)te, nact, __ldg(a.hs + te - 1));
  }
  int32_t nxt = after;  // the first start after step c
#pragma unroll
  for (int c = CHUNKS - 1; c >= 0; --c) {
    const unsigned later = m[c] & ~((2u << lane) - 1u);
    int32_t end = later ? (int32_t)(w0 + 32 * c + __ffs(later) - 1) : nxt;
    end = end < nact ? end : nact;
    const int64_t p = w0 + 32 * c + lane;
    const uint32_t cnt = (m[c] >> lane) & 1u ? (uint32_t)(end - p) : 0u;
    key[c] = p < a.n ? ((uint64_t)cnt << 32) | (uint64_t)(~(uint32_t)p) : 0ull;
    if (m[c]) nxt = (int32_t)(w0 + 32 * c + __ffs(m[c]) - 1);
  }
}

// ---------------------------------------------------------------------------
// SMALL: a warp's k largest keys, lane j holding the j-th (0 past k)

// The warp's 32 keys sorted descending across the lanes (bitonic, by shuffles).
__device__ __forceinline__ uint64_t warp_sort_desc(uint64_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint64_t y = __shfl_xor_sync(dbt::FULL_MASK, x, stride);
      // in a descending run of `size` lanes the lower lane of a pair keeps the larger
      x = (((lane & stride) == 0) == ((lane & size) == 0)) ? max(x, y) : min(x, y);
    }
  return x;
}

// A bitonic sequence across the lanes sorted descending.
__device__ __forceinline__ uint64_t warp_merge_desc(uint64_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const uint64_t y = __shfl_xor_sync(dbt::FULL_MASK, x, stride);
    x = (lane & stride) == 0 ? max(x, y) : min(x, y);
  }
  return x;
}

// The step's keys x that beat the warp's k-th and the floor enter the list
// v, lowest lane first, each by a shuffle insert.
__device__ __forceinline__ void warp_offer(uint64_t& v, uint64_t& thr, uint64_t x, int k,
                                           uint64_t floor) {
  const int lane = threadIdx.x & 31;
  unsigned cand = __ballot_sync(dbt::FULL_MASK, x > thr);
  while (cand) {
    const int c = __ffs(cand) - 1;
    const uint64_t y = __shfl_sync(dbt::FULL_MASK, x, c);
    const int at = __popc(__ballot_sync(dbt::FULL_MASK, v > y));  // < k: y beats the k-th
    const uint64_t up = __shfl_up_sync(dbt::FULL_MASK, v, 1);
    if (lane == at) v = y;
    else if (lane > at && lane < k) v = up;
    thr = max(floor, __shfl_sync(dbt::FULL_MASK, v, k - 1));
    cand &= ~(1u << c) & __ballot_sync(dbt::FULL_MASK, x > thr);
  }
}

// The block's k largest of its warps' sorted lists, in s[0, k): three
// levels of pairs, each warp of a pair taking the 32 largest of its list
// and its partner's (the larger of A[j] and B[31 - j], a bitonic sequence)
// and sorting them by a bitonic merge.
__device__ __forceinline__ void merge_warps(uint64_t v, uint64_t* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s[threadIdx.x] = v;  // warp w's lane j at w * 32 + j
#pragma unroll
  for (int level = 1; level < WARPS; level <<= 1) {
    __syncthreads();
    if (warp % (2 * level) == 0) {
      v = warp_merge_desc(max(v, s[(warp + level) * 32 + 31 - lane]));
      s[threadIdx.x] = v;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// BIG: the block's k largest keys in s[0, k), a buffer of entrants behind

struct BlockList {
  uint64_t* s;   // [BIG_SORT]
  int* cnt;      // entrants in the buffer s[k, k + *cnt)
  uint64_t* thr; // what a key must beat: s[k - 1] after a sort, or the floor
  int k;
};

// Sort s[0, N) descending (N a power of 2) by the block's threads.
__device__ void bitonic_desc(uint64_t* s, int N) {
  for (int size = 2; size <= N; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < N / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const uint64_t x = s[lo], y = s[hi];
        if ((x < y) == ((lo & size) == 0)) {
          s[lo] = y;
          s[hi] = x;
        }
      }
    }
  __syncthreads();
}

// An empty list whose keys must beat `floor`.
__device__ __forceinline__ void clear(const BlockList& b, uint64_t floor) {
  for (int i = threadIdx.x; i < b.k; i += THREADS) b.s[i] = 0ull;
  if (threadIdx.x == 0) {
    *b.cnt = 0;
    *b.thr = floor;
  }
  __syncthreads();
}

// Sort list and buffer, as few keys as a power of 2 holds, and keep the k
// largest; every thread calls it.
__device__ __noinline__ void flush(const BlockList& b) {
  __syncthreads();
  const int used = b.k + *b.cnt;
  int size = 64;
  while (size < used) size <<= 1;
  for (int i = used + threadIdx.x; i < size; i += THREADS) b.s[i] = 0ull;
  const uint64_t floor = *b.thr;
  bitonic_desc(b.s, size);
  if (threadIdx.x == 0) {
    *b.cnt = 0;
    *b.thr = max(floor, b.s[b.k - 1]);
  }
  __syncthreads();
}

// A round: BIG_ROUND keys a thread enter the buffer where they beat the
// k-th; every thread calls it.
__device__ __forceinline__ void block_offer(const BlockList& b, const uint64_t (&x)[BIG_ROUND]) {
  const int lane = threadIdx.x & 31;
  const bool full = *b.cnt + BIG_ROUND * THREADS > BIG_SORT - b.k;
  __syncthreads();  // every thread has read the count before any warp adds to it
  if (full) flush(b);
  const uint64_t thr = *b.thr;
#pragma unroll
  for (int r = 0; r < BIG_ROUND; ++r) {
    const bool in = x[r] > thr;
    const unsigned ins = __ballot_sync(dbt::FULL_MASK, in);
    int base = 0;
    if (lane == 0 && ins) base = atomicAdd(b.cnt, __popc(ins));
    base = __shfl_sync(dbt::FULL_MASK, base, 0);
    if (in) b.s[b.k + base + __popc(ins & ((1u << lane) - 1u))] = x[r];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------

// One below the largest of the tiles' k-th keys (0 where every tile's is
// 0): the k-th largest key of all is at least that k-th key, so no key at
// or under the result is among the k largest.  Every thread of the block
// calls it and gets it.
__device__ uint64_t merge_floor(const uint64_t* winners, int64_t tiles, int k, uint64_t* s_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint64_t m = 0ull;
  for (int64_t t = threadIdx.x; t < tiles; t += THREADS) m = max(m, __ldcg(winners + t * k + k - 1));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(dbt::FULL_MASK, m, off));
  if (lane == 0) s_max[warp] = m;
  __syncthreads();
  m = 0ull;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) m = max(m, s_max[w]);
  __syncthreads();
  return m > 0ull ? m - 1ull : 0ull;  // m is 0 only where no tile holds k keys
}

template <bool BIG>
__global__ void __launch_bounds__(THREADS) topk_kernel(Args a) {
  __shared__ uint64_t s[BIG ? BIG_SORT : THREADS];
  __shared__ uint64_t s_max[WARPS];
  __shared__ int32_t s_first[WARPS];
  __shared__ int s_cnt;
  __shared__ uint64_t s_thr;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  int32_t nact = *a.nact;
  nact = nact < 0 ? 0 : (nact > a.n ? a.n : nact);
  const int k = a.k;
  uint64_t key[CHUNKS];
  tile_keys(a, nact, (int64_t)blockIdx.x * TILE, key, s_first);
  const BlockList bl{s, &s_cnt, &s_thr, k};
  if constexpr (BIG) {
    clear(bl, 0ull);
#pragma unroll
    for (int c = 0; c < CHUNKS; c += BIG_ROUND) {
      uint64_t x[BIG_ROUND];
#pragma unroll
      for (int r = 0; r < BIG_ROUND; ++r) x[r] = key[c + r];
      block_offer(bl, x);
      if (c == 0) flush(bl);  // an early k-th, so that later rounds enter few keys
    }
    flush(bl);
  } else {
    // the first step's keys sorted make the list; later steps insert
    uint64_t v = warp_sort_desc(key[0]);
    v = lane < k ? v : 0ull;
    uint64_t thr = __shfl_sync(dbt::FULL_MASK, v, k - 1);
#pragma unroll
    for (int c = 1; c < CHUNKS; ++c) warp_offer(v, thr, key[c], k, 0ull);
    merge_warps(v, s);
  }
  for (int j = threadIdx.x; j < k; j += THREADS) a.winners[(int64_t)blockIdx.x * k + j] = s[j];
  // the last block to finish merges the tiles' keys
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int64_t m = (int64_t)gridDim.x * k;
  const uint64_t floor = merge_floor(a.winners, gridDim.x, k, s_max);
  if constexpr (BIG) {
    clear(bl, floor);
    for (int64_t base = 0; base < m; base += BIG_ROUND * THREADS) {
      uint64_t x[BIG_ROUND];
#pragma unroll
      for (int r = 0; r < BIG_ROUND; ++r) {
        const int64_t j = base + r * THREADS + threadIdx.x;
        x[r] = j < m ? __ldcg(a.winners + j) : 0ull;
      }
      block_offer(bl, x);
    }
    flush(bl);
  } else {
    uint64_t v = 0ull, thr = floor;
    const int warp = threadIdx.x >> 5;
    constexpr int BATCH = 4;  // steps whose loads are in flight together
    for (int64_t base = (int64_t)warp * 32; base < m; base += (int64_t)BATCH * THREADS) {
      uint64_t x[BATCH];
#pragma unroll
      for (int r = 0; r < BATCH; ++r) {
        const int64_t j = base + (int64_t)r * THREADS + lane;
        x[r] = j < m ? __ldcg(a.winners + j) : 0ull;
      }
#pragma unroll
      for (int r = 0; r < BATCH; ++r) warp_offer(v, thr, x[r], k, floor);
    }
    merge_warps(v, s);
  }
  for (int j = threadIdx.x; j < k; j += THREADS) {
    const uint64_t best = s[j];
    a.top_hash[j] = (int32_t)__ldg(a.hs + (~(uint32_t)(best & 0xFFFFFFFFull)));
    a.top_count[j] = (int32_t)(best >> 32);
  }
}

}  // namespace

DBT_API int64_t dbt_topk_runs_scratch_words(int64_t n, int k) {
  const int64_t tiles = n > 0 ? (n + TILE - 1) / TILE : 1;
  return 2 + 2 * tiles * (int64_t)k;  // the done counter and a word to 8 bytes; a key a pick
}

// hs u32[n], sorted unsigned over its first nact rows (nact: one i32 on the
// device); 1 <= k <= min(n, MAX_K); top_hash i32[k], top_count i32[k];
// scratch of dbt_topk_runs_scratch_words(n, k) 32-bit words, 8-byte aligned.
// One memset of the done counter and one launch.
DBT_API int dbt_topk_runs(const void* hs, int64_t n, const void* nact, int k, void* top_hash,
                          void* top_count, void* scratch, int64_t scratch_words, void* stream) {
  if (n < 1 || n > INT32_MAX || k < 1 || k > n || k > MAX_K ||
      scratch_words < dbt_topk_runs_scratch_words(n, k) ||
      reinterpret_cast<uintptr_t>(scratch) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + TILE - 1) / TILE;
  uint32_t* w = static_cast<uint32_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(w, 0, sizeof(uint32_t), st);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.hs = static_cast<const uint32_t*>(hs);
  a.n = (int32_t)n;
  a.nact = static_cast<const int32_t*>(nact);
  a.k = k;
  a.done = w;
  a.winners = reinterpret_cast<uint64_t*>(w + 2);
  a.top_hash = static_cast<int32_t*>(top_hash);
  a.top_count = static_cast<int32_t*>(top_count);
  if (k <= SMALL_K)
    topk_kernel<false><<<(unsigned)tiles, THREADS, 0, st>>>(a);
  else
    topk_kernel<true><<<(unsigned)tiles, THREADS, 0, st>>>(a);
  DBT_CHECK_LAUNCH();
  return 0;
}
