// K20 and K21: the hot-hash list of the skew join and membership in it.
//
// K20 replaces the candidate reduction of the JAX package's hot_hash_set
// (parallel/skew.py:68-88).  Its input is the all-gathered top-k candidates
// of every shard, m = ndev * k hashes with their run counts.  Candidate i is
// hot where it is the first occurrence of its hash among the candidates
// (argmax of the equality row), the counts of all candidates with its hash
// sum above the threshold (compared signed, as JAX compares its int32 sum),
// and its hash is not the sentinel 0xFFFFFFFF; hot[i] is its hash, or the
// sentinel.  The candidates (8 B each) sit in shared memory, one thread a
// candidate compares its hash with all m: m is ndev * 16 on the path, so one
// block of 1024 threads holds them up to 64 shards.
//
// K21 replaces in_hash_set (parallel/skew.py:91-96): a row is in the set
// where its hash equals a hot entry that is not the sentinel.  Each block
// copies the list's non-sentinel entries (at most 2 * ndev * 16 words) into
// shared memory once, and its threads walk the rows, one row a thread and
// step, against the copied entries only (the hot keys: a few).
//
// Bound on the H100: K20 is a few hundred bytes and m^2 compares, so launch
// latency; K21 bytes, 4 B in and 1 B out a row.
#include "common.cuh"

namespace {

constexpr int HOT_THREADS = 1024;
constexpr int IN_THREADS = 256;
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(HOT_THREADS)
    hot_hashes_kernel(const uint32_t* __restrict__ gh, const int32_t* __restrict__ gc, int32_t m,
                      const int32_t* __restrict__ threshold, uint32_t* __restrict__ hot) {
  extern __shared__ uint32_t s_mem[];
  uint32_t* s_h = s_mem;
  int32_t* s_c = reinterpret_cast<int32_t*>(s_mem + m);
  for (int32_t j = threadIdx.x; j < m; j += blockDim.x) {
    s_h[j] = gh[j];
    s_c[j] = gc[j];
  }
  __syncthreads();
  const int32_t i = (int32_t)(blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= m) return;
  const uint32_t h = s_h[i];
  uint32_t tot = 0u;  // int32 arithmetic, wrapping as JAX's sum does
  bool first = true;
  for (int32_t j = 0; j < m; ++j) {
    if (s_h[j] == h) {
      tot += (uint32_t)s_c[j];
      first &= j >= i;
    }
  }
  const bool is_hot = first && (int32_t)tot > *threshold && h != SENTINEL;
  hot[i] = is_hot ? h : SENTINEL;
}

__global__ void __launch_bounds__(IN_THREADS)
    in_hot_set_kernel(const uint32_t* __restrict__ hashes, int64_t n,
                      const uint32_t* __restrict__ hot, int32_t mh, bool* __restrict__ out) {
  extern __shared__ uint32_t s_hot[];
  __shared__ int32_t s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  for (int32_t j = threadIdx.x; j < mh; j += blockDim.x) {
    const uint32_t v = hot[j];
    if (v != SENTINEL) s_hot[atomicAdd(&s_n, 1)] = v;  // the order does not matter
  }
  __syncthreads();
  const int32_t live = s_n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t h = __ldcs(hashes + i);
    bool f = false;
    for (int32_t j = 0; j < live; ++j) f |= s_hot[j] == h;
    out[i] = f;
  }
}

int set_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// gh u32[m], gc i32[m], threshold one i32 on the device; hot u32[m].
DBT_API int dbt_hot_hashes(const void* gh, const void* gc, int64_t m, const void* threshold,
                           void* hot, void* stream) {
  if (m < 0 || (size_t)m * 8u > 232448u) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const size_t bytes = (size_t)m * 8u;
  int err = set_shared((const void*)hot_hashes_kernel, bytes);
  if (err) return err;
  hot_hashes_kernel<<<dbt::blocks_for(m, HOT_THREADS), HOT_THREADS, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(gh), static_cast<const int32_t*>(gc), (int32_t)m,
      static_cast<const int32_t*>(threshold), static_cast<uint32_t*>(hot));
  DBT_CHECK_LAUNCH();
  return 0;
}

// hashes u32[n], hot u32[mh] (0xFFFFFFFF never matches); out bool[n].
DBT_API int dbt_in_hot_set(const void* hashes, int64_t n, const void* hot, int64_t mh, void* out,
                           void* stream) {
  if (n < 0 || mh < 0 || (size_t)mh * 4u > 232448u - 16u) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t bytes = (size_t)(mh > 0 ? mh : 1) * 4u;
  int err = set_shared((const void*)in_hot_set_kernel, bytes);
  if (err) return err;
  int64_t blocks = (n + IN_THREADS - 1) / IN_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // each block copies the list once
  in_hot_set_kernel<<<(unsigned)blocks, IN_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hashes), n, static_cast<const uint32_t*>(hot), (int32_t)mh,
      static_cast<bool*>(out));
  DBT_CHECK_LAUNCH();
  return 0;
}
