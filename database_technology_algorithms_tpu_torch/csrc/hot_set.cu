// K20 and K21: the hot-hash list of the skew join and membership in it.
//
// K20 replaces the candidate reduction of the JAX package's hot_hash_set
// (parallel/skew.py:68-88).  Its input is a side's all-gathered top-k
// candidates of every shard, m = ndev * k hashes with their run counts.
// Candidate i is hot where it is the first occurrence of its hash among its
// side's candidates (argmax of the equality row), the counts of all of that
// side's candidates with its hash sum above the threshold (compared signed,
// as JAX compares its int32 sum), and its hash is not the sentinel
// 0xFFFFFFFF; hot[i] is its hash, or the sentinel.  One launch takes both
// sides of the skew join, the probe side's list and then the build side's
// (hot = cat([hot_p, hot_b]) of the JAX form), each side's threshold
// max(tot // div, 1) worked out on the card from its psum'd count tot, and
// writes n_hot, the list's live entries; a one-sided call (hot_hashes)
// passes its threshold itself (div 0) and no count.  The candidates (8 B
// each) sit in shared memory, one thread a candidate compares its hash with
// its side's:
// - block mode (both sides together at most HOT_THREADS candidates, the
//   path's 2 * ndev * 16 up to 32 shards): one block stages both lists,
//   thread i takes candidate i of the concatenated list, and n_hot is the
//   block's count of live entries, which its last barrier takes
//   (__syncthreads_count: no atomic, no memset, no shared memory);
// - grid mode (up to dist_plan.HOT_MAX_CANDIDATES a side, which fill the
//   227 KB a block may take): a block a chunk of HOT_THREADS candidates of
//   one side, which it stages whole; each block adds its count to n_hot,
//   zeroed by a memset first.
// kernels/dist_plan.py hot_plan chooses the mode, the threads and the grid.
//
// K21 replaces in_hash_set (parallel/skew.py:91-96): a row is in the set
// where its hash equals a hot entry that is not the sentinel.
//
// Bound on the H100: K20 is a few hundred bytes and m^2 compares, so launch
// latency, paid once a device for both sides; K21 bytes, 4 B in and 1 B out
// a row (5 MB at 1M rows, 1.5 us).  So K21 keeps each thread's row loads in flight across the block's
// staging of the list, and moves the rows in wide accesses:
// - a thread takes R rows a step (dist_plan.IN_SET_ROWS = 8).  Where the
//   hashes are contiguous and aligned to 4R bytes (at most 16) and the
//   output to R (the vector path) it reads them by one 4R-byte load (two
//   16-byte ones at R = 8) and writes their R bools as one R-byte store;
//   the thread just past the last whole group takes the n % R rows of the
//   tail one by one.  Otherwise (the scalar path: a view that starts off
//   16 bytes) its rows lie blockDim apart, each warp's load one run;
// - the thread issues its first rows' loads before the block stages the
//   list and reaches its barrier, so the list's round trip overlaps the
//   rows';
// - a short list (scan mode, at most dist_plan.IN_SET_SCAN_MAX entries,
//   the path's 2 * ndev * hh_topk) is staged as its live entries only, in
//   order, each warp's ranks from a ballot and the warps' offsets from
//   their counts (no shared atomic), and a row is compared with each; the
//   grid covers the rows once;
// - a long list (search mode, up to IN_SET_MAX_HOT entries) is staged the
//   same way (as it is, where the warps' counts do not fit beside it) and
//   sorted in shared memory by a bitonic network whose comparators all put
//   the smaller value first, so the entries past the staged ones act as
//   +inf and are never touched; a row then takes a lower-bound search (a
//   sentinel left in the list sorts last and never matches).  The block
//   sorts once and walks the rows (a persistent grid).
// kernels/dist_plan.py in_set_plan chooses the path, the mode, the threads
// and the grid; the entry below refuses what the kernels were not built for.
#include "common.cuh"

namespace {

constexpr int HOT_THREADS = 1024;  // a block-mode block at most, a grid-mode block
constexpr int IN_MAX_THREADS = 1024;  // a K21 block, at most
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

// Both sides of K20: side 0 (the probe side) is candidates 0 .. m0 - 1 of
// the concatenated list, side 1 the m1 after them.
struct HotSides {
  const uint32_t *gh0, *gh1;
  const int32_t *gc0, *gc1;
  const int32_t *tot0, *tot1;
  int32_t m0, m1;
  int64_t div;  // the threshold is max(tot // div, 1); at 0, tot itself
};

__device__ __forceinline__ int32_t side_threshold(const int32_t* tot, int64_t div) {
  const int64_t t = __ldg(tot);
  if (div == 0) return (int32_t)t;
  const int64_t q = t / div - (t % div != 0 && t < 0);  // torch's floor division (div > 0)
  return (int32_t)(q > 1 ? q : 1);
}

// Each block stages the candidates [lo, hi) of the concatenated list: both
// sides in block mode, its side in grid mode, where block k takes chunk k of
// side 0 and the blocks after side 0's take side 1's chunks.
__global__ void __launch_bounds__(HOT_THREADS)
    hot_lists_kernel(HotSides a, uint32_t* __restrict__ hot, int32_t* __restrict__ n_hot,
                     bool block_mode) {
  extern __shared__ uint32_t s_mem[];
  const int32_t m = a.m0 + a.m1;
  int32_t lo = 0, hi = m, g = (int32_t)threadIdx.x;
  if (!block_mode) {
    const int32_t blocks0 = (a.m0 + (int32_t)blockDim.x - 1) / (int32_t)blockDim.x;
    const bool second = (int32_t)blockIdx.x >= blocks0;
    lo = second ? a.m0 : 0;
    hi = second ? m : a.m0;
    g = lo + ((int32_t)blockIdx.x - (second ? blocks0 : 0)) * (int32_t)blockDim.x +
        (int32_t)threadIdx.x;
  }
  const bool mine = g < hi;
  const bool side1 = g >= a.m0;
  const int32_t thr = mine ? side_threshold(side1 ? a.tot1 : a.tot0, a.div) : 0;
  const int32_t n = hi - lo;
  uint32_t* s_h = s_mem;
  int32_t* s_c = reinterpret_cast<int32_t*>(s_mem + n);
  for (int32_t j = threadIdx.x; j < n; j += blockDim.x) {
    const int32_t q = lo + j;
    s_h[j] = q < a.m0 ? __ldg(a.gh0 + q) : __ldg(a.gh1 + (q - a.m0));
    s_c[j] = q < a.m0 ? __ldg(a.gc0 + q) : __ldg(a.gc1 + (q - a.m0));
  }
  __syncthreads();
  uint32_t v = SENTINEL;
  if (mine) {
    const int32_t i = g - lo;
    const int32_t from = (side1 ? a.m0 : 0) - lo, to = (side1 ? m : a.m0) - lo;
    const uint32_t h = s_h[i];
    uint32_t tot = 0u;  // int32 arithmetic, wrapping as JAX's sum does
    bool first = true;
    for (int32_t j = from; j < to; ++j) {
      if (s_h[j] == h) {
        tot += (uint32_t)s_c[j];
        first &= j >= i;
      }
    }
    if (first && (int32_t)tot > thr && h != SENTINEL) v = h;
    hot[g] = v;
  }
  if (n_hot == nullptr) return;
  // the block's live entries, counted by the barrier itself (no shared
  // memory beside the candidates, which may fill the block's 227 KB)
  const int32_t live = __syncthreads_count(v != SENTINEL);
  if (threadIdx.x == 0) {
    if (block_mode)
      *n_hot = live;
    else if (live)
      atomicAdd(n_hot, live);
  }
}

int set_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A thread's rows in unit u: the vector path's rows Ru .. Ru + R - 1 (or,
// for u == n / R, the tail), the scalar path's rows c * RT + t + k * T of
// chunk c = u / T, thread t = u % T (T = blockDim.x).  The rows taken are a
// prefix of the R.
template <int R>
struct Rows {
  uint32_t h[R];
  int64_t first;
  int count;
};

template <int R>
__device__ __forceinline__ Rows<R> load_rows(const uint32_t* __restrict__ hashes, int64_t n,
                                             int64_t u, bool vec) {
  Rows<R> r;
  const int64_t t = blockDim.x;
  if (vec) {
    const int64_t full = n / R;
    r.first = u * R;
    if (u < full) {
      const uint32_t* p = hashes + r.first;
      if constexpr (R == 1) {
        r.h[0] = __ldcs(p);
      } else if constexpr (R == 2) {
        const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
        r.h[0] = v.x;
        r.h[1] = v.y;
      } else {
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + q);
          r.h[4 * q] = v.x;
          r.h[4 * q + 1] = v.y;
          r.h[4 * q + 2] = v.z;
          r.h[4 * q + 3] = v.w;
        }
      }
      r.count = R;
    } else {
      r.count = u == full ? (int)(n - full * R) : 0;
#pragma unroll
      for (int k = 0; k < R; ++k) r.h[k] = k < r.count ? __ldcs(hashes + r.first + k) : 0u;
    }
  } else {
    r.first = (u / t) * t * R + u % t;
    r.count = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t i = r.first + k * t;
      r.h[k] = i < n ? __ldcs(hashes + i) : 0u;
      r.count += i < n;
    }
  }
  return r;
}

template <int R>
__device__ __forceinline__ void store_rows(bool* __restrict__ out, const Rows<R>& r,
                                           const bool (&f)[R], bool vec) {
  if (vec && r.count == R) {
    uint64_t packed = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) packed |= (uint64_t)f[k] << (8 * k);
    bool* p = out + r.first;
    if constexpr (R == 1) *reinterpret_cast<uint8_t*>(p) = (uint8_t)packed;
    if constexpr (R == 2) *reinterpret_cast<uint16_t*>(p) = (uint16_t)packed;
    if constexpr (R == 4) *reinterpret_cast<uint32_t*>(p) = (uint32_t)packed;
    if constexpr (R == 8) *reinterpret_cast<uint64_t*>(p) = packed;
    return;
  }
  const int64_t step = vec ? 1 : blockDim.x;
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < r.count) out[r.first + k * step] = f[k];
}

// Scan mode's staging: the live entries of hot[0, mh) into s_hot in their
// order, a round of blockDim entries at a time; s_warp (blockDim / 32
// words) holds each warp's count of a round.  Returns the live count.
__device__ __forceinline__ int32_t stage_live(const uint32_t* __restrict__ hot, int32_t mh,
                                              uint32_t* s_hot, int32_t* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  int32_t live = 0;
  for (int32_t c = 0; c < mh; c += blockDim.x) {
    const int32_t j = c + threadIdx.x;
    const uint32_t v = j < mh ? __ldg(hot + j) : SENTINEL;
    const unsigned ballot = __ballot_sync(dbt::FULL_MASK, v != SENTINEL);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int32_t off = live, total = 0;
    for (int w = 0; w < warps; ++w) {
      const int32_t k = s_warp[w];
      off += w < warp ? k : 0;
      total += k;
    }
    if (v != SENTINEL) s_hot[off + __popc(ballot & ((1u << lane) - 1u))] = v;
    live += total;
    __syncthreads();  // the entries are in, and s_warp may be written again
  }
  return live;
}

// A comparator of the sort between lane partners: the partner's index is
// i ^ xor_mask, and the index whose `bit` is clear keeps the smaller value.
__device__ __forceinline__ uint32_t compare_lanes(uint32_t v, int32_t i, int xor_mask, int bit) {
  const uint32_t o = __shfl_xor_sync(dbt::FULL_MASK, v, xor_mask);
  return (i & bit) == 0 ? min(v, o) : max(v, o);
}

// The steps of the sort whose pairs lie within 32 indices, in registers: a
// warp holds 32 consecutive entries, a lane one (past m: 0xFFFFFFFF, which
// a comparator leaves in place at the upper index, as it leaves +inf).
// `tail`: the steps j = 16 .. 1 of one stage; else every stage up to kmax.
__device__ __forceinline__ void sort_in_warps(uint32_t* s_hot, int32_t m, int32_t p,
                                              int32_t kmax, bool tail) {
  for (int32_t c = 0; c * (int32_t)blockDim.x < p; ++c) {
    const int32_t i = c * (int32_t)blockDim.x + (int32_t)threadIdx.x;
    uint32_t v = i < m ? s_hot[i] : SENTINEL;
    if (tail) {
      for (int j = 16; j > 0; j >>= 1) v = compare_lanes(v, i, j, j);
    } else {
      for (int k = 2; k <= kmax; k <<= 1) {
        v = compare_lanes(v, i, k - 1, k >> 1);  // the stage's mirror step
        for (int j = k >> 2; j > 0; j >>= 1) v = compare_lanes(v, i, j, j);
      }
    }
    if (i < m) s_hot[i] = v;
  }
}

// Search mode's sort of s_hot[0, m) in place.  A bitonic network over the
// next power of two p >= m whose every comparator puts the smaller value at
// the lower index: a stage k first pairs each index i of a k-block's lower
// half with its mirror i ^ (k - 1), then pairs i with i + j for j = k/4 ..
// 1.  An index past m holds +inf in this view, so a pair that reaches past
// m keeps its values and is skipped.  The steps whose pairs lie within 32
// indices (every stage up to 32, and j = 16 .. 1 of the later ones) run in
// registers by warp shuffles, one shared-memory load and store an entry
// for several steps; the others a step at a time in shared memory.
__device__ __forceinline__ void sort_shared(uint32_t* s_hot, int32_t m) {
  __syncthreads();
  int32_t p = 1;
  while (p < m) p <<= 1;
  if (p < 2) return;
  sort_in_warps(s_hot, m, p, p < 32 ? p : 32, false);
  __syncthreads();
  for (int32_t k = 64; k <= p; k <<= 1) {
    for (int32_t j = k >> 1; j >= 32; j >>= 1) {
      for (int32_t i = threadIdx.x; i < (p >> 1); i += blockDim.x) {
        const int32_t lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int32_t hi = j == (k >> 1) ? lo ^ (k - 1) : lo + j;
        if (hi < m) {
          const uint32_t a = s_hot[lo], b = s_hot[hi];
          if (b < a) {
            s_hot[lo] = b;
            s_hot[hi] = a;
          }
        }
      }
      __syncthreads();
    }
    sort_in_warps(s_hot, m, p, k, true);
    __syncthreads();
  }
}

// One launch over units first, first + gridDim.x * blockDim.x, ...; the
// first unit's rows are read before the list is staged.
// `compact`: the list staged as its live entries (always in scan mode; in
// search mode where the warps' counts fit beside the list), else as it is.
template <int R, bool SEARCH>
__global__ void __launch_bounds__(IN_MAX_THREADS)
    in_hot_set_kernel(const uint32_t* __restrict__ hashes, int64_t n,
                      const uint32_t* __restrict__ hot, int32_t mh, bool* __restrict__ out,
                      bool vec, bool compact) {
  extern __shared__ uint32_t s_hot[];
  const int64_t t = blockDim.x;
  const int64_t units = vec ? (n + R - 1) / R : (n + t * R - 1) / (t * R) * t;
  const int64_t first = (int64_t)blockIdx.x * t + threadIdx.x;
  Rows<R> r = load_rows<R>(hashes, n, first, vec);
  int32_t live = mh;
  if (compact) {
    live = stage_live(hot, mh, s_hot, reinterpret_cast<int32_t*>(s_hot + mh));
  } else {
    for (int32_t j = threadIdx.x; j < mh; j += blockDim.x) s_hot[j] = __ldg(hot + j);
  }
  if constexpr (SEARCH) sort_shared(s_hot, live);
  int32_t top = 1;  // the largest power of two <= live: the search's first step
  while (top * 2 <= live) top <<= 1;
  for (int64_t u = first; u < units; u += (int64_t)gridDim.x * t) {
    if (u != first) r = load_rows<R>(hashes, n, u, vec);
    bool f[R];
    if constexpr (SEARCH) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const uint32_t h = r.h[k];
        int32_t pos = 0;  // the entries below h
        for (int32_t s = top; s > 0; s >>= 1)
          if (pos + s <= live && s_hot[pos + s - 1] < h) pos += s;
        f[k] = h != SENTINEL && pos < live && s_hot[pos] == h;
      }
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) f[k] = false;
      for (int32_t j = 0; j < live; ++j) {
        const uint32_t e = s_hot[j];
#pragma unroll
        for (int k = 0; k < R; ++k) f[k] |= r.h[k] == e;
      }
    }
    store_rows<R>(out, r, f, vec);
  }
}

template <int R>
int launch_in_hot_set(const uint32_t* hashes, int64_t n, const uint32_t* hot, int32_t mh,
                      bool* out, bool vec, bool search, bool compact, int threads,
                      int64_t blocks, size_t bytes, cudaStream_t st) {
  const void* fn = search ? (const void*)in_hot_set_kernel<R, true>
                          : (const void*)in_hot_set_kernel<R, false>;
  int err = set_shared(fn, bytes);
  if (err) return err;
  if (search)
    in_hot_set_kernel<R, true><<<(unsigned)blocks, threads, bytes, st>>>(hashes, n, hot, mh, out,
                                                                          vec, compact);
  else
    in_hot_set_kernel<R, false><<<(unsigned)blocks, threads, bytes, st>>>(hashes, n, hot, mh,
                                                                           out, vec, compact);
  DBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Side s: gh_s u32[m_s], gc_s i32[m_s], tot_s one i32 on the device; hot
// u32[m_p + m_b]; n_hot one i32 (or null: no count).  div >= 1: each side's
// threshold is max(tot_s // div, 1); div 0: tot_p is the threshold itself
// (m_b must be 0).  The plan (kernels/dist_plan.py hot_plan): block mode (one
// block of threads >= m_p + m_b) or grid mode (blocks = ceil(m_p / threads) +
// ceil(m_b / threads)).
DBT_API int dbt_hot_lists(const void* gh_p, const void* gc_p, int64_t m_p, const void* tot_p,
                          const void* gh_b, const void* gc_b, int64_t m_b, const void* tot_b,
                          int64_t div, void* hot, void* n_hot, int block_mode, int threads,
                          int64_t blocks, void* stream) {
  const int64_t most = 232448 / 8;
  if (m_p < 0 || m_b < 0 || m_p > most || m_b > most || div < 0 || (div == 0 && m_b) ||
      threads < 32 || threads > HOT_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int64_t m = m_p + m_b;
  const int64_t staged = block_mode ? m : (m_p > m_b ? m_p : m_b);
  if (block_mode ? (m > threads || blocks != 1)
                 : blocks != (m_p + threads - 1) / threads + (m_b + threads - 1) / threads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks == 0) return 0;
  if (!block_mode && n_hot) {
    const cudaError_t err = cudaMemsetAsync(n_hot, 0, 4, st);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t bytes = (size_t)staged * 8u;
  int err = set_shared((const void*)hot_lists_kernel, bytes);
  if (err) return err;
  HotSides a;
  a.gh0 = static_cast<const uint32_t*>(gh_p);
  a.gh1 = static_cast<const uint32_t*>(gh_b);
  a.gc0 = static_cast<const int32_t*>(gc_p);
  a.gc1 = static_cast<const int32_t*>(gc_b);
  a.tot0 = static_cast<const int32_t*>(tot_p);
  a.tot1 = static_cast<const int32_t*>(tot_b);
  a.m0 = (int32_t)m_p;
  a.m1 = (int32_t)m_b;
  a.div = div;
  hot_lists_kernel<<<(unsigned)blocks, threads, bytes, st>>>(
      a, static_cast<uint32_t*>(hot), static_cast<int32_t*>(n_hot), block_mode != 0);
  DBT_CHECK_LAUNCH();
  return 0;
}

// hashes u32[n], hot u32[mh] (0xFFFFFFFF never matches); out bool[n].  The
// plan (kernels/dist_plan.py in_set_plan): rows a thread (1, 2, 4, 8), vec
// (a contiguous column read R rows a load), search (a sorted list), threads
// and blocks.
DBT_API int dbt_in_hot_set(const void* hashes, int64_t n, const void* hot, int64_t mh, void* out,
                           int rows, int vec, int search, int threads, int64_t blocks,
                           void* stream) {
  if (n < 0 || n > INT32_MAX || mh < 0 || threads < 32 || threads > IN_MAX_THREADS ||
      threads % 32 || blocks < 1 || blocks > INT32_MAX ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8))
    return (int)cudaErrorInvalidValue;
  // the list, and each warp's count of a staging round after it where it fits
  const size_t list = (size_t)(mh > 0 ? mh : 1) * 4u;
  const bool compact = list + (size_t)threads / 8u <= 232448u;
  if (!compact && !search) return (int)cudaErrorInvalidValue;
  const size_t bytes = list + (compact ? (size_t)threads / 8u : 0u);
  if (bytes > 232448u) return (int)cudaErrorInvalidValue;
  const size_t align = rows < 4 ? 4u * rows : 16u;
  if (vec && (reinterpret_cast<uintptr_t>(hashes) % align ||
              reinterpret_cast<uintptr_t>(out) % (uintptr_t)rows))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const uint32_t* h = static_cast<const uint32_t*>(hashes);
  const uint32_t* l = static_cast<const uint32_t*>(hot);
  bool* o = static_cast<bool*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch_in_hot_set<1>(h, n, l, (int32_t)mh, o, vec, search, compact, threads,
                                        blocks, bytes, st);
    case 2: return launch_in_hot_set<2>(h, n, l, (int32_t)mh, o, vec, search, compact, threads,
                                        blocks, bytes, st);
    case 4: return launch_in_hot_set<4>(h, n, l, (int32_t)mh, o, vec, search, compact, threads,
                                        blocks, bytes, st);
    default: return launch_in_hot_set<8>(h, n, l, (int32_t)mh, o, vec, search, compact, threads,
                                         blocks, bytes, st);
  }
}
