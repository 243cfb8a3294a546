// K16 and K17: the open-addressing hash set of u32 keys, its build and its
// probe.
//
// Replaces the JAX package's build_hash_set (ops/hash_table.py:50-105) and
// probe_hash_set (ops/hash_table.py:108-146): a power-of-two table of
// _mix(key) values with linear probing, filled by parallel insertion and
// probed by hash, read and compare.
//
// Bound on the H100: bytes and L2 transactions.  A build key is read once
// and costs a trip to its home slot, and a compare-and-swap where that
// reads EMPTY; a probe key one trip a 16-byte window of slots.  At the
// path's sizes the table is 8 MB (1M build keys, 2^21 slots) and in the
// 50 MB L2, or 64 MB (8M, 2^24 slots) and not.  A table of keys drawn from
// 3 rows / 10 values is about 14% full, so most keys settle at their home
// slot.  On the card the build is bound by the rate of the random L2
// transactions (1M plain stores to random slots take about as long as the
// insert), not by their latency, so the plan (kernels/engines_plan.py
// hash_plan, chosen by tools/hash_sweep.py) keeps one key a thread; its
// numbers:
// - a thread takes K keys (HASH_KEYS, 1 in the plan): where the keys are
//   contiguous and aligned to 4K bytes (16 at most) by one load (two
//   16-byte ones at K = 8), the thread past the last whole group taking
//   the n % K keys of the tail; otherwise K keys blockDim apart.  It mixes
//   them in registers, issues all K home trips before it looks at any, then
//   all the compare-and-swaps they call for;
// - a read takes the aligned window of W slots (HASH_WINDOW = 4, 16 bytes)
//   that holds the key's next slot, and the key walks the window's slots
//   from there in order, so a taken slot's successors cost no further trip
//   until the window ends.  Windows are aligned and the size a power of two
//   of at least W, so a window never crosses the table's end.
// The table is filled with EMPTY and the meta words zeroed first, by one
// fill launch (a little faster than the two memsets it replaced).
//
// K17 (kernels/engines_plan.py set_probe_plan, chosen by tools/hash_sweep.py)
// takes the build's key loader and windows: at 1M keys it sits at the rate
// of random L2 reads, one a key; at 8M the 64 MB table does not fit the L2
// and most windows come from device memory.  So:
// - a thread takes PROBE_KEYS = 2 keys (one 8-byte load where the keys are
//   contiguous and aligned), issues both home windows before it looks at
//   either, and stores its flags and counts 2 at a time; a block is
//   PROBE_THREADS = 256 threads;
// - where the table is past SET_PROBE_STREAM_BYTES the keys are read and
//   the outputs written evict-first (__ldcs/__stcs), so they pass through
//   the L2 without pushing table lines out;
// - each block adds its hits into a 0-d total that the entry zeroes on the
//   call's stream, so a caller needs no sum over mult.
// Passes over L2-sized ranges of a large table (a pass the keys whose home
// lies in its range), with or without a prefetch of the range, an evict-last
// policy on the table's reads, 1 or 4 keys a thread, and blocks of 128 or
// 512 threads all measured slower (PERF.md, "forms tried"): every pass
// rereads every key and writes outputs in partial sectors.  The walk is the
// same for either window: from the home slot, at most max_probe slots,
// stopping at the key's mix or at EMPTY; the key whose mix is EMPTY reads
// the flag; rows past the live count are not found.
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
// A slot once written never changes, so a window's value other than EMPTY
// is final, and one that reads EMPTY is settled by a compare-and-swap on
// that slot, as a read of the one slot would be: the walk visits the slots
// from home in the same order and with the same outcome as a walk of one
// read a slot, so these invariants hold for every plan.  The table's layout
// depends on the order of the atomics; the set it holds does not while no
// key fails.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;        // the fill's block
constexpr int MAX_THREADS = 1024;   // a K16 block, at most
constexpr int PROBE_KEYS = 2;       // a K17 thread's keys
constexpr int PROBE_THREADS = 256;  // a K17 block
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

// A thread's keys: the vector path's keys Ku .. Ku + K - 1 (or, for u ==
// n / K, the tail), the scalar path's keys c * KT + t + k * T of chunk
// c = u / T, thread t = u % T (T = blockDim.x).  The keys taken are a
// prefix of the K.  STREAM reads them evict-first (K17), else through the
// read-only path (K16).
template <int K>
struct Keys {
  uint32_t v[K];
  int64_t first;
  int64_t step;
  int count;
};

template <bool STREAM, typename T>
__device__ __forceinline__ T load_one(const T* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return __ldg(p);
}

template <int K, bool STREAM = false>
__device__ __forceinline__ Keys<K> load_keys(const uint32_t* __restrict__ keys, int64_t n,
                                             int64_t u, bool vec) {
  Keys<K> r;
  const int64_t t = blockDim.x;
  if (vec) {
    const int64_t full = n / K;
    r.first = u * K;
    r.step = 1;
    if (u < full) {
      const uint32_t* p = keys + r.first;
      if constexpr (K == 1) {
        r.v[0] = load_one<STREAM>(p);
      } else if constexpr (K == 2) {
        const uint2 x = load_one<STREAM>(reinterpret_cast<const uint2*>(p));
        r.v[0] = x.x;
        r.v[1] = x.y;
      } else {
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
          const uint4 x = load_one<STREAM>(reinterpret_cast<const uint4*>(p) + q);
          r.v[4 * q] = x.x;
          r.v[4 * q + 1] = x.y;
          r.v[4 * q + 2] = x.z;
          r.v[4 * q + 3] = x.w;
        }
      }
      r.count = K;
    } else {
      r.count = u == full ? (int)(n - full * K) : 0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        r.v[k] = k < r.count ? load_one<STREAM>(keys + r.first + k) : 0u;
    }
  } else {
    r.first = (u / t) * t * K + u % t;
    r.step = t;
    r.count = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t i = r.first + k * t;
      r.v[k] = i < n ? load_one<STREAM>(keys + i) : 0u;
      r.count += i < n;
    }
  }
  return r;
}

// The aligned window of W slots that holds `slot`, read through L2: the
// launch itself writes the table, so no read-only or L1 path.
template <int W>
__device__ __forceinline__ void read_window(const uint32_t* table, uint32_t slot,
                                            uint32_t (&win)[W]) {
  if constexpr (W == 1) {
    win[0] = __ldcg(table + slot);
  } else {
    static_assert(W == 4, "a window is one slot or one 16-byte load");
    const uint4 x = __ldcg(reinterpret_cast<const uint4*>(table) + (slot >> 2));
    win[0] = x.x;
    win[1] = x.y;
    win[2] = x.z;
    win[3] = x.w;
  }
}

// Walk the window from `slot`, having tried `d` slots: a slot that holds h
// ends the walk, one that reads EMPTY is settled by a CAS (won, or lost to
// h: the end; lost to another key: on), a slot of another key is passed.
// Returns true when the key is settled: stored, found, or failed after
// `limit` slots (counted); else moves `slot` to the next window's first
// slot.
template <int W>
__device__ __forceinline__ bool settle(uint32_t h, uint32_t& slot, int& d, int limit,
                                       uint32_t* table, uint32_t mask, const uint32_t (&win)[W],
                                       int32_t* meta) {
  const uint32_t base = slot & ~(uint32_t)(W - 1);
  const int from = (int)(slot & (W - 1));
#pragma unroll
  for (int s = 0; s < W; ++s) {
    if (s < from) continue;
    if (d == limit) break;
    uint32_t cur = win[s];
    if (cur == EMPTY) cur = atomicCAS(table + base + s, EMPTY, h);
    if (cur == EMPTY || cur == h) return true;
    ++d;
  }
  if (d == limit) {
    atomicAdd(meta + 1, 1);
    return true;
  }
  slot = (base + W) & mask;
  return false;
}

// meta[0]: the EMPTY-key flag; meta[1]: keys that failed.  The grid covers
// the keys once.
template <int K, int W>
__global__ void __launch_bounds__(MAX_THREADS)
    hash_set_build_kernel(const uint32_t* __restrict__ keys, int32_t n,
                          const int32_t* __restrict__ cnt_dev, int32_t cnt_host,
                          uint32_t* __restrict__ table, uint32_t mask, int limit,
                          int32_t* __restrict__ meta, bool vec) {
  const Keys<K> r = load_keys<K>(keys, n, (int64_t)blockIdx.x * blockDim.x + threadIdx.x, vec);
  const int64_t live = cnt_dev ? *cnt_dev : cnt_host;
  uint32_t h[K], slot[K];
  bool pending[K];
  int d[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    h[k] = mix(r.v[k]);
    pending[k] = k < r.count && r.first + k * r.step < live;
    if (pending[k] && h[k] == EMPTY) {
      meta[0] = 1;  // every such thread writes the same value
      pending[k] = false;
    }
    slot[k] = h[k] & mask;
    d[k] = 0;
  }
  // every home window in flight at once
  uint32_t win[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (pending[k]) read_window<W>(table, slot[k], win[k]);
  // each key's first slot of its window that holds it (found) or reads
  // EMPTY (to CAS), passing other keys' slots
  int cas_at[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cas_at[k] = -1;
    if (!pending[k]) continue;
    const uint32_t base = slot[k] & ~(uint32_t)(W - 1);
    const int from = (int)(slot[k] & (W - 1));
    bool stop = false;
#pragma unroll
    for (int s = 0; s < W; ++s) {
      if (s < from || stop || d[k] == limit) continue;
      if (win[k][s] == h[k]) {
        pending[k] = false;
        stop = true;
      } else if (win[k][s] == EMPTY) {
        cas_at[k] = (int)(base + s);
        stop = true;
      } else {
        ++d[k];
      }
    }
    if (pending[k] && cas_at[k] < 0) {
      if (d[k] == limit) {
        atomicAdd(meta + 1, 1);
        pending[k] = false;
      } else {
        slot[k] = (base + W) & mask;
      }
    }
  }
  // every CAS in flight at once, then their outcomes: won, or lost to the
  // same key, is the end; lost to another key walks on from the next slot
  uint32_t cur[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (cas_at[k] >= 0) cur[k] = atomicCAS(table + cas_at[k], EMPTY, h[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (cas_at[k] < 0) continue;
    if (cur[k] == EMPTY || cur[k] == h[k]) {
      pending[k] = false;
    } else {
      ++d[k];
      slot[k] = ((uint32_t)cas_at[k] + 1) & mask;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    while (pending[k]) {
      uint32_t w[W];
      read_window<W>(table, slot[k], w);
      pending[k] = !settle<W>(h[k], slot[k], d[k], limit, table, mask, w, meta);
    }
  }
}

// The table to EMPTY and meta to 0 in one launch.
__global__ void __launch_bounds__(THREADS)
    hash_set_fill_kernel(uint32_t* __restrict__ table, int64_t size, int32_t* __restrict__ meta) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  if (i == 0) {
    meta[0] = 0;
    meta[1] = 0;
  }
  if (size < 4) {
    if (i < size) table[i] = EMPTY;
    return;
  }
  for (int64_t q = i; q < size / 4; q += stride)
    reinterpret_cast<uint4*>(table)[q] = make_uint4(EMPTY, EMPTY, EMPTY, EMPTY);
}

template <int K>
void launch_build(int window, int64_t blocks, int threads, cudaStream_t s,
                  const uint32_t* keys, int32_t n, const int32_t* cnt, int32_t cnt_host,
                  uint32_t* table, uint32_t mask, int limit, int32_t* meta, bool vec) {
  if (window == 4)
    hash_set_build_kernel<K, 4><<<(unsigned)blocks, threads, 0, s>>>(
        keys, n, cnt, cnt_host, table, mask, limit, meta, vec);
  else
    hash_set_build_kernel<K, 1><<<(unsigned)blocks, threads, 0, s>>>(
        keys, n, cnt, cnt_host, table, mask, limit, meta, vec);
}

// The window of W slots that holds `slot`, read through the read-only path
// (the probe writes no slot).
template <int W>
__device__ __forceinline__ void read_window_ro(const uint32_t* __restrict__ table, uint32_t slot,
                                               uint32_t (&win)[W]) {
  if constexpr (W == 1) {
    win[0] = __ldg(table + slot);
  } else {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(table) + (slot >> 2));
    win[0] = x.x;
    win[1] = x.y;
    win[2] = x.z;
    win[3] = x.w;
  }
}

// An output word, evict-first with `stream`.
template <typename T>
__device__ __forceinline__ void store_out(T* p, T v, bool stream) {
  if (stream) __stcs(p, v);
  else *p = v;
}

// The probe's walk over the window from `slot`, having tried `d` slots: the
// key's mix ends it found, EMPTY or the max_probe-th slot not found.
// Returns true when the key is settled; else moves `slot` to the next
// window's first slot.
template <int W>
__device__ __forceinline__ bool probe_window(uint32_t q, uint32_t& slot, int& d, int max_probe,
                                             uint32_t mask, const uint32_t (&win)[W], bool& f) {
  const uint32_t base = slot & ~(uint32_t)(W - 1);
  const int from = (int)(slot & (W - 1));
#pragma unroll
  for (int s = 0; s < W; ++s) {
    if (s < from) continue;
    if (d == max_probe) return true;
    if (win[s] == q) {
      f = true;
      return true;
    }
    if (win[s] == EMPTY) return true;
    ++d;
  }
  if (d == max_probe) return true;
  slot = (base + W) & mask;
  return false;
}

// The grid covers the keys once, PROBE_KEYS a thread.  total, where not
// null, gains the found keys; `stream` reads the keys and writes the
// outputs evict-first.
template <int W>
__global__ void __launch_bounds__(PROBE_THREADS)
    hash_set_probe_kernel(const uint32_t* __restrict__ table, uint32_t mask,
                          const int32_t* __restrict__ meta, const uint32_t* __restrict__ keys,
                          int32_t n, const int32_t* __restrict__ cnt_dev, int32_t cnt_host,
                          int max_probe, uint8_t* __restrict__ found, int32_t* __restrict__ mult,
                          int32_t* __restrict__ total, bool vec, bool stream) {
  constexpr int K = PROBE_KEYS;
  const int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Keys<K> r = stream ? load_keys<K, true>(keys, n, u, vec) : load_keys<K>(keys, n, u, vec);
  const int64_t live = cnt_dev ? *cnt_dev : cnt_host;
  uint32_t q[K], slot[K];
  bool walk[K], f[K];
  int d[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    q[k] = mix(r.v[k]);
    const bool is_live = k < r.count && r.first + k * r.step < live;
    slot[k] = q[k] & mask;
    walk[k] = is_live && q[k] != EMPTY && max_probe > 0;
    f[k] = is_live && q[k] == EMPTY && meta[0] != 0;  // the flag read by that key alone
    d[k] = 0;
  }
  // every home window in flight at once, then each walk
  uint32_t win[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (walk[k]) read_window_ro<W>(table, slot[k], win[k]);
#pragma unroll
  for (int k = 0; k < K; ++k)
    walk[k] = walk[k] && !probe_window<W>(q[k], slot[k], d[k], max_probe, mask, win[k], f[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    while (walk[k]) {
      uint32_t w[W];
      read_window_ro<W>(table, slot[k], w);
      walk[k] = !probe_window<W>(q[k], slot[k], d[k], max_probe, mask, w, f[k]);
    }
  }
  int hits = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) hits += f[k];
  static_assert(K == 2, "the vector path stores 2 flags and 2 counts");
  if (vec && r.count == K) {
    store_out(reinterpret_cast<uchar2*>(found + r.first), make_uchar2(f[0], f[1]), stream);
    store_out(reinterpret_cast<int2*>(mult + r.first), make_int2(f[0], f[1]), stream);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k >= r.count) break;
      store_out(found + r.first + k * r.step, (uint8_t)f[k], stream);
      store_out(mult + r.first + k * r.step, (int32_t)f[k], stream);
    }
  }
  if (total) {  // the same for every block: no thread skips the barriers
    __shared__ int block_hits;
    if (threadIdx.x == 0) block_hits = 0;
    __syncthreads();
    hits = __reduce_add_sync(dbt::FULL_MASK, hits);
    if ((threadIdx.x & 31) == 0 && hits) atomicAdd(&block_hits, hits);
    __syncthreads();
    if (threadIdx.x == 0 && block_hits) atomicAdd(total, block_hits);
  }
}

}  // namespace

// keys u32[n] (the first count live: cnt one i32 on the device, or null and
// cnt_host); table u32[size], size a power of two; meta i32[2].  Fills the
// table with EMPTY and meta with 0, then inserts, under the plan
// (kernels/engines_plan.py hash_plan): keys a thread (1, 2, 4, 8), threads
// a block, the window (1 or 4 slots), vec (the keys read K a load) and the
// insert's blocks.
DBT_API int dbt_hash_set_build(const void* keys, int64_t n, const void* cnt, int64_t cnt_host,
                               void* table, int64_t size, int limit, void* meta,
                               int keys_per_thread, int threads, int window, int vec,
                               int64_t blocks, void* stream) {
  const int k = keys_per_thread;
  if (n < 0 || n > INT32_MAX || size < 1 || size > (int64_t(1) << 31) || (size & (size - 1)) ||
      limit < 0 || (k != 1 && k != 2 && k != 4 && k != 8) || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || (window != 1 && window != 4) || size < window ||
      reinterpret_cast<uintptr_t>(table) % (4u * window))
    return (int)cudaErrorInvalidValue;
  if (vec && reinterpret_cast<uintptr_t>(keys) % (k < 4 ? 4u * k : 16u))
    return (int)cudaErrorInvalidValue;
  if (n > 0 && (blocks < 1 || blocks > INT32_MAX || blocks * threads * k < n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t fill_blocks = std::min<int64_t>((size / 4 + THREADS - 1) / THREADS + 1, 132 * 16);
  hash_set_fill_kernel<<<(unsigned)fill_blocks, THREADS, 0, s>>>(
      static_cast<uint32_t*>(table), size, static_cast<int32_t*>(meta));
  DBT_CHECK_LAUNCH();
  if (n == 0) return 0;
  const auto* kp = static_cast<const uint32_t*>(keys);
  const auto* cp = static_cast<const int32_t*>(cnt);
  auto* tp = static_cast<uint32_t*>(table);
  auto* mp = static_cast<int32_t*>(meta);
  const auto mask = (uint32_t)(size - 1);
  switch (k) {
    case 1: launch_build<1>(window, blocks, threads, s, kp, (int32_t)n, cp, (int32_t)cnt_host, tp,
                            mask, limit, mp, vec != 0); break;
    case 2: launch_build<2>(window, blocks, threads, s, kp, (int32_t)n, cp, (int32_t)cnt_host, tp,
                            mask, limit, mp, vec != 0); break;
    case 4: launch_build<4>(window, blocks, threads, s, kp, (int32_t)n, cp, (int32_t)cnt_host, tp,
                            mask, limit, mp, vec != 0); break;
    default: launch_build<8>(window, blocks, threads, s, kp, (int32_t)n, cp, (int32_t)cnt_host,
                             tp, mask, limit, mp, vec != 0);
  }
  DBT_CHECK_LAUNCH();
  return 0;
}

// table u32[size] and meta i32[2] from dbt_hash_set_build; keys u32[n] with
// their live count as above; found bool[n], mult i32[n]; total one i32 (or
// null), zeroed here on the stream, gains the found keys.  The plan
// (kernels/engines_plan.py set_probe_plan): the window (1 or 4 slots), vec
// (keys read and outputs written 2 at a time) and stream (both
// evict-first); the grid covers the keys once.
DBT_API int dbt_hash_set_probe(const void* table, int64_t size, const void* meta, const void* keys,
                               int64_t n, const void* cnt, int64_t cnt_host, int max_probe,
                               void* found, void* mult, void* total, int window, int vec,
                               int stream, void* stream_ptr) {
  if (n < 0 || n > INT32_MAX || size < 1 || size > (int64_t(1) << 31) || (size & (size - 1)) ||
      (window != 1 && window != 4) || size < window ||
      reinterpret_cast<uintptr_t>(table) % (4u * window))
    return (int)cudaErrorInvalidValue;
  if (vec && (reinterpret_cast<uintptr_t>(keys) % (4u * PROBE_KEYS) ||
              reinterpret_cast<uintptr_t>(found) % PROBE_KEYS ||
              reinterpret_cast<uintptr_t>(mult) % (4u * PROBE_KEYS)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (total) {
    cudaMemsetAsync(total, 0, sizeof(int32_t), s);
    DBT_CHECK_LAUNCH();
  }
  if (n == 0) return 0;
  const auto* tp = static_cast<const uint32_t*>(table);
  const auto* mp = static_cast<const int32_t*>(meta);
  const auto* kp = static_cast<const uint32_t*>(keys);
  const auto* cp = static_cast<const int32_t*>(cnt);
  auto* fp = static_cast<uint8_t*>(found);
  auto* up = static_cast<int32_t*>(mult);
  auto* op = static_cast<int32_t*>(total);
  const auto mask = (uint32_t)(size - 1);
  const int64_t per_block = (int64_t)PROBE_THREADS * PROBE_KEYS;
  const auto grid = (unsigned)((n + per_block - 1) / per_block);
  if (window == 4)
    hash_set_probe_kernel<4><<<grid, PROBE_THREADS, 0, s>>>(
        tp, mask, mp, kp, (int32_t)n, cp, (int32_t)cnt_host, max_probe, fp, up, op, vec != 0,
        stream != 0);
  else
    hash_set_probe_kernel<1><<<grid, PROBE_THREADS, 0, s>>>(
        tp, mask, mp, kp, (int32_t)n, cp, (int32_t)cnt_host, max_probe, fp, up, op, vec != 0,
        stream != 0);
  DBT_CHECK_LAUNCH();
  return 0;
}
