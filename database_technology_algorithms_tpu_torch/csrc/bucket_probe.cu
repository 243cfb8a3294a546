// K18: the bucket compare of the bucketed semi-join.
//
// Replaces the JAX package's padded [B, cap] build table, its [B, cap_p,
// cap_b] broadcast compare and the overflow rule of _bucket_table and
// _bucketed_matched (ops/bucket_join.py:59-158).  Both sides arrive sorted
// by bucket (K1 over (inactive, bucket, row), inactive rows in bucket B),
// with their keys carried; per bucket b < B, every live probe key of b is
// compared with every live build key of b; a bucket holding more than cap
// rows on either side overflows (the JAX rule: the rows past cap are
// counted) and its probe rows get no hit, since the caller then takes the
// exact fallback.  The result is a hit per probe row in the probe side's
// sorted order; K7 returns it to probe order.
//
// Bound on the H100: latency.  The bytes are the two sides' bucket and key
// columns read once and a bool written a probe row; the compares (about 16
// x 16 a bucket at the layout's mean) are few.  One warp a bucket: lanes 0-3
// find the bucket's range on the two sides by four binary searches of the
// sorted bucket columns at once (no count of buckets through K9, which
// refuses more than 58,111 of them), the build keys go to the warp's slice of
// shared memory, and each lane compares its probe rows with all of them
// (broadcast reads).  Bucket B, the inactive rows, gets no hit.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_CAP = 128;  // kernels/engines_plan.py BUCKET_MAX_CAP

__device__ __forceinline__ int32_t lower_bound(const int32_t* __restrict__ col, int32_t n,
                                               int32_t v) {
  int32_t lo = 0, hi = n;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(col + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    bucket_probe_kernel(const int32_t* __restrict__ b_bucket, const uint32_t* __restrict__ b_key,
                        int32_t nb, const int32_t* __restrict__ p_bucket,
                        const uint32_t* __restrict__ p_key, int32_t np, int32_t nbuckets,
                        int32_t cap, bool* __restrict__ hit, int32_t* __restrict__ ovf) {
  __shared__ uint32_t keys[WARPS][MAX_CAP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  if (b > nbuckets) return;  // warp-uniform
  int32_t r = 0;
  if (lane < 4) {  // lanes 0, 1: the build side's [lb, hb); 2, 3: the probe side's
    r = lane < 2 ? lower_bound(b_bucket, nb, (int32_t)b + (lane & 1))
                 : lower_bound(p_bucket, np, (int32_t)b + (lane & 1));
  }
  const int32_t lb = __shfl_sync(dbt::FULL_MASK, r, 0), hb = __shfl_sync(dbt::FULL_MASK, r, 1);
  const int32_t lp = __shfl_sync(dbt::FULL_MASK, r, 2), hp = __shfl_sync(dbt::FULL_MASK, r, 3);
  const int32_t cb = hb - lb, cp = hp - lp;
  const bool live = b < nbuckets;
  if (!live || cb > cap || cp > cap) {
    if (live && lane == 0) atomicAdd(ovf, max(cb - cap, 0) + max(cp - cap, 0));
    for (int32_t i = lp + lane; i < hp; i += 32) hit[i] = false;
    return;
  }
  for (int32_t j = lane; j < cb; j += 32) keys[warp][j] = __ldg(b_key + lb + j);
  __syncwarp();
  for (int32_t i = lp + lane; i < hp; i += 32) {
    const uint32_t p = __ldg(p_key + i);
    bool h = false;
    for (int32_t j = 0; j < cb; ++j) h |= keys[warp][j] == p;
    hit[i] = h;
  }
}

}  // namespace

// b_bucket i32[nb] and p_bucket i32[np]: non-decreasing, in [0, nbuckets];
// b_key u32[nb], p_key u32[np] beside them; hit bool[np]; ovf one i32.
DBT_API int dbt_bucket_probe(const void* b_bucket, const void* b_key, int64_t nb,
                             const void* p_bucket, const void* p_key, int64_t np,
                             int64_t nbuckets, int cap, void* hit, void* ovf, void* stream) {
  if (nb < 0 || nb > INT32_MAX || np < 0 || np > INT32_MAX || nbuckets < 1 ||
      nbuckets >= INT32_MAX || cap < 0 || cap > MAX_CAP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ovf, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  bucket_probe_kernel<<<dbt::blocks_for(nbuckets + 1, WARPS), THREADS, 0, s>>>(
      static_cast<const int32_t*>(b_bucket), static_cast<const uint32_t*>(b_key), (int32_t)nb,
      static_cast<const int32_t*>(p_bucket), static_cast<const uint32_t*>(p_key), (int32_t)np,
      (int32_t)nbuckets, cap, static_cast<bool*>(hit), static_cast<int32_t*>(ovf));
  DBT_CHECK_LAUNCH();
  return 0;
}
