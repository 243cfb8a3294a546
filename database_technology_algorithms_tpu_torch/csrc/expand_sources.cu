// K14: the expansion sources.
//
// Replaces the JAX package's source search in materialize_field3_device
// (ops/hash_join.py:682-686): output row i of a segmented expansion, which
// emits probe row j mult[j] times, comes from probe row
// searchsorted(c, i, 'right') = #{j : c[j] <= i}, where c is the inclusive
// int32 cumsum of mult; rows at or past the total take the fill row nprobe.
// c[nprobe - 1] is the total, so #{j : c[j] <= i} is nprobe for every
// i >= total as well: the sources are the merge of two sorted sequences, the
// output positions 0 .. cap - 1 and c, ties to c, and the kernel reads no
// total.
//
// Bound on the H100: bytes, c in and src out (7.85 MB at the field-3 run's
// 1M probe rows, 2.3 us).  A binary search an output row made every row 20
// dependent trips to the L2; a merge path (Odeh, Green, Mwassi, Shmueli and
// Birk 2012) gives each block one search:
// - the merge of cap + nprobe items is cut into blocks of NV = T * V
//   consecutive items.  Entry j of c sits at merge position
//   f(j) = j + min(c[j], cap), strictly increasing in j, so the entries
//   before diagonal d number b(d) = #{j : f(j) < d}, the outputs d - b(d);
// - warp 0 finds b at the block's first diagonal and warp 1 at its last, each
//   by a 32-ary search of c: a step reads 32 spaced entries, one a lane, and
//   a ballot narrows the range 32-fold (4 steps at a million entries);
// - the block loads its slice of c (at most NV entries) into shared memory,
//   by coalesced 16-byte loads where aligned, as min(c, cap) - a0: the
//   output position, local to the block, that the entry comes before;
// - each thread finds its diagonal t * V in the slice by a binary search in
//   shared memory and merges its V items serially: an entry at or below the
//   next output position is passed over, else that output takes the entries
//   passed so far (b(d0) plus the local count);
// - the outputs, staged in shared memory, leave by coalesced 16-byte stores
//   where aligned.
// Each block does NV items however skewed mult is: a heavy row spreads over
// blocks as outputs, a run of zero multiplicities as entries of c.  Merge
// positions are int64 (cap + nprobe reaches 2^32 - 2).  kernels/scan_plan.py
// expand_plan chooses T, V and the grid; the entry below repeats its
// refusals.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr size_t MAX_SHARED = 232448 - 16;  // the dynamic part: s_split takes 16 bytes

// b(d) = #{j < nprobe : j + min(c[j], cap) < d}, by one warp.  The answer
// lies in [lo, hi]; a step probes lo + (L + 1) * s - 1 at lane L (s the
// range's 32nd part, rounded up), the lanes whose probe lies before d are a
// prefix, and lo moves past them.
__device__ __forceinline__ int64_t diagonal_split(const int32_t* __restrict__ c, int64_t nprobe,
                                                  int64_t cap, int64_t d) {
  const int64_t lane = threadIdx.x & 31;
  int64_t lo = d > cap ? d - cap : 0;
  int64_t hi = d < nprobe ? d : nprobe;
  while (lo < hi) {
    const int64_t s = (hi - lo + 31) >> 5;
    const int64_t p = lo + (lane + 1) * s - 1;
    bool before = false;
    if (p < hi) {
      const int64_t v = __ldg(c + p);
      before = p + (v < cap ? v : cap) < d;
    }
    lo += (int64_t)__popc(__ballot_sync(dbt::FULL_MASK, before)) * s;
    hi = lo + s - 1 < hi ? lo + s - 1 : hi;
  }
  return lo;
}

__device__ __forceinline__ int32_t local_position(int32_t v, int64_t cap, int64_t a0) {
  return (int32_t)(((int64_t)v < cap ? (int64_t)v : cap) - a0);
}

// s[j] = min(p[j], cap) - a0 for j < n: single entries up to p's first
// 16-byte boundary, then 16-byte loads, then the tail.
__device__ __forceinline__ void load_slice(const int32_t* __restrict__ p, int n, int64_t cap,
                                           int64_t a0, int32_t* s) {
  const int head = min(n, (int)((16u - (reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) >> 2);
  const int vecs = (n - head) >> 2;
  for (int j = threadIdx.x; j < head; j += blockDim.x) s[j] = local_position(__ldg(p + j), cap, a0);
  const int4* pv = reinterpret_cast<const int4*>(p + head);
  for (int q = threadIdx.x; q < vecs; q += blockDim.x) {
    const int4 v = __ldg(pv + q);
    int32_t* o = s + head + 4 * q;
    o[0] = local_position(v.x, cap, a0);
    o[1] = local_position(v.y, cap, a0);
    o[2] = local_position(v.z, cap, a0);
    o[3] = local_position(v.w, cap, a0);
  }
  for (int j = head + 4 * vecs + threadIdx.x; j < n; j += blockDim.x)
    s[j] = local_position(__ldg(p + j), cap, a0);
}

// dst[j] = s[j] for j < n, the same way.
__device__ __forceinline__ void store_outputs(int32_t* __restrict__ dst, int n, const int32_t* s) {
  const int head = min(n, (int)((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) >> 2);
  const int vecs = (n - head) >> 2;
  for (int j = threadIdx.x; j < head; j += blockDim.x) dst[j] = s[j];
  int4* dv = reinterpret_cast<int4*>(dst + head);
  for (int q = threadIdx.x; q < vecs; q += blockDim.x) {
    const int32_t* o = s + head + 4 * q;
    dv[q] = make_int4(o[0], o[1], o[2], o[3]);
  }
  for (int j = head + 4 * vecs + threadIdx.x; j < n; j += blockDim.x) dst[j] = s[j];
}

__global__ void __launch_bounds__(MAX_THREADS)
    expand_sources_kernel(const int32_t* __restrict__ c, int64_t nprobe, int64_t cap,
                          int32_t* __restrict__ src, int items) {
  extern __shared__ int32_t s_mem[];
  __shared__ int64_t s_split[2];
  const int nv = (int)blockDim.x * items;
  int32_t* s_c = s_mem;         // the block's slice of c, as local output positions
  int32_t* s_out = s_mem + nv;  // the block's outputs
  const int64_t n = cap + nprobe;
  const int64_t d0 = (int64_t)blockIdx.x * nv;
  const int64_t d1 = d0 + nv < n ? d0 + nv : n;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t b = diagonal_split(c, nprobe, cap, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) s_split[warp] = b;
  }
  __syncthreads();
  const int64_t b0 = s_split[0];
  const int64_t a0 = d0 - b0;
  const int nb = (int)(s_split[1] - b0);
  const int items_here = (int)(d1 - d0);
  const int na = items_here - nb;
  load_slice(c + b0, nb, cap, a0, s_c);
  __syncthreads();
  const int dt = (int)threadIdx.x * items;
  if (dt < items_here) {
    // the slice's entries before the thread's diagonal: j + s_c[j] < dt
    int lo = dt > na ? dt - na : 0, hi = dt < nb ? dt : nb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mid + s_c[mid] < dt)
        lo = mid + 1;
      else
        hi = mid;
    }
    int bt = lo, at = dt - lo;
    const int end = dt + items < items_here ? dt + items : items_here;
    for (int k = dt; k < end; ++k) {
      if (bt < nb && s_c[bt] <= at) {
        ++bt;
      } else {
        s_out[at] = (int32_t)(b0 + bt);
        ++at;
      }
    }
  }
  __syncthreads();
  store_outputs(src + a0, na, s_out);
}

}  // namespace

// c i32[nprobe], the inclusive cumsum of the multiplicities (its last entry
// the total); src i32[cap].  The plan (kernels/scan_plan.py expand_plan):
// threads a block (whole warps, at least two), merge items a thread, and
// blocks = ceil((cap + nprobe) / (threads * items)).
DBT_API int dbt_expand_sources(const void* c, int64_t nprobe, int64_t cap, void* src, int threads,
                               int items, int64_t blocks, void* stream) {
  if (nprobe < 0 || nprobe > INT32_MAX || cap < 0 || cap > INT32_MAX || threads < 64 ||
      threads > MAX_THREADS || threads % 32 || items < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t nv = (int64_t)threads * items;
  const size_t bytes = (size_t)nv * 8u;
  if (bytes > MAX_SHARED || blocks != (cap + nprobe + nv - 1) / nv || blocks > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expand_sources_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  expand_sources_kernel<<<(unsigned)blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c), nprobe, cap, static_cast<int32_t*>(src), items);
  DBT_CHECK_LAUNCH();
  return 0;
}
