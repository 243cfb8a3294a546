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
// Bound on the H100: bytes, the two sides' bucket and key columns read once
// and a bool written a probe row; the compares (about 16 x 16 a bucket at
// the layout's mean) are few.  The first form found each bucket's ranges by
// four binary searches of whole columns a warp, 20 dependent reads before any
// compare, and left half of each warp without a probe row.  Now:
//   1. starts_kernel, a thread four rows of each side (one int4 load), and
//      one past its end, writes the first row of every bucket that begins
//      there: row i every b in (bucket[i-1], bucket[i]], the end every b up to
//      B + 1.  Each entry of starts[0 .. B + 1] is written once, with no
//      memset and no atomics; a warp writes a long run of empty buckets
//      together.
//   2. compare_kernel gives a block a span of consecutive buckets (32:
//      about 512 rows a side at the layout's mean).  One warp reads the span's
//      starts, applies the overflow rule (an atomic add a bucket that
//      overflows) and places the kept buckets' build keys; the block stages
//      them into shared memory, as one coalesced range when no bucket of the
//      span overflows; each thread then takes one probe row of the span (read
//      while the keys are staged) and compares its key with its own
//      bucket's build keys only.  The inactive
//      probe rows (bucket B) get no hit from every block in turn.
#include "common.cuh"

namespace {

constexpr int STARTS_THREADS = 256;
constexpr int STARTS_ROWS = 4;  // rows a thread, read as one int4 where the column is aligned
constexpr int MAX_CAP = 128;   // kernels/engines_plan.py BUCKET_MAX_CAP
constexpr int MAX_SPAN = 32;   // kernels/engines_plan.py BUCKET_MAX_SPAN

__global__ void __launch_bounds__(STARTS_THREADS)
    starts_kernel(const int32_t* __restrict__ b_bucket, int32_t nb,
                  const int32_t* __restrict__ p_bucket, int32_t np, int32_t nbuckets,
                  uint32_t build_blocks, bool vec, int32_t* __restrict__ starts) {
  const bool probe = blockIdx.x >= build_blocks;
  const int32_t* col = probe ? p_bucket : b_bucket;
  const int32_t n = probe ? np : nb;
  int32_t* st = starts + (probe ? (int64_t)nbuckets + 2 : 0);
  const int64_t i0 = ((int64_t)(blockIdx.x - (probe ? build_blocks : 0)) * STARTS_THREADS +
                      threadIdx.x) * STARTS_ROWS;
  const int64_t last = (int64_t)nbuckets + 1;
  // b[r + 1]: the bucket of row i0 + r (last for the row past the end);
  // b[0]: the row before i0's (-1 before row 0)
  int64_t b[STARTS_ROWS + 1];
  b[0] = i0 == 0 || i0 > n ? -1 : (int64_t)__ldg(col + i0 - 1);
  if (vec && i0 + STARTS_ROWS <= n) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(col + i0));
    b[1] = v.x;
    b[2] = v.y;
    b[3] = v.z;
    b[4] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < STARTS_ROWS; ++r)
      b[r + 1] = i0 + r < n ? (int64_t)__ldg(col + i0 + r) : last;
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < STARTS_ROWS; ++r) {
    const int64_t i = i0 + r;  // row i starts buckets [lo, hi]
    int64_t lo = b[r] + 1 < 0 ? 0 : b[r] + 1;
    int64_t hi = b[r + 1] > last ? last : b[r + 1];
    if (i > n) hi = lo - 1;
    const bool wide = hi - lo >= 32;
    if (!wide)
      for (int64_t k = lo; k <= hi; ++k) st[k] = (int32_t)i;
    for (unsigned w = __ballot_sync(dbt::FULL_MASK, wide); w; w &= w - 1) {
      const int l = __ffs(w) - 1;
      const int64_t wlo = __shfl_sync(dbt::FULL_MASK, lo, l);
      const int64_t whi = __shfl_sync(dbt::FULL_MASK, hi, l);
      const int32_t wi = (int32_t)__shfl_sync(dbt::FULL_MASK, i, l);
      for (int64_t k = wlo + lane; k <= whi; k += 32) st[k] = wi;
    }
  }
}

__device__ __forceinline__ int32_t clamp_row(int32_t r, int32_t n) {
  return r < 0 ? 0 : (r > n ? n : r);
}

__global__ void compare_kernel(const int32_t* __restrict__ starts,
                               const uint32_t* __restrict__ b_key, int32_t nb,
                               const int32_t* __restrict__ p_bucket,
                               const uint32_t* __restrict__ p_key, int32_t np, int32_t nbuckets,
                               int32_t cap, int32_t span, bool* __restrict__ hit,
                               int32_t* __restrict__ ovf) {
  extern __shared__ uint32_t keys[];       // the span's kept build keys
  __shared__ int32_t off[MAX_SPAN];        // a bucket's first key in keys; -1: it overflows
  __shared__ int32_t cnt[MAX_SPAN];        // its build keys
  __shared__ int32_t bnd[4];               // the span's first build row, its kept build
                                           // keys, its probe rows [bnd[2], bnd[3])
  __shared__ int32_t any_over;
  const int32_t* st_b = starts;
  const int32_t* st_p = starts + (int64_t)nbuckets + 2;
  const int64_t b0 = (int64_t)blockIdx.x * span;
  const int32_t nspan = (int32_t)min((int64_t)span, (int64_t)nbuckets - b0);
  if (threadIdx.x < 32) {
    const int k = threadIdx.x;
    int32_t lb = 0, hb = 0, lp = 0, hp = 0;
    if (k < nspan) {
      lb = clamp_row(__ldg(st_b + b0 + k), nb);
      hb = clamp_row(__ldg(st_b + b0 + k + 1), nb);
      lp = clamp_row(__ldg(st_p + b0 + k), np);
      hp = clamp_row(__ldg(st_p + b0 + k + 1), np);
    }
    const int32_t cb = max(hb - lb, 0), cp = max(hp - lp, 0);
    const bool over = k < nspan && (cb > cap || cp > cap);
    if (over) atomicAdd(ovf, max(cb - cap, 0) + max(cp - cap, 0));
    int32_t kept = over ? 0 : cb, sum = kept;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t v = __shfl_up_sync(dbt::FULL_MASK, sum, d);
      if (k >= d) sum += v;
    }
    if (k < nspan) {
      off[k] = over ? -1 : sum - kept;
      cnt[k] = cb;
    }
    const unsigned overs = __ballot_sync(dbt::FULL_MASK, over);
    const int32_t first_b = __shfl_sync(dbt::FULL_MASK, lb, 0);
    const int32_t first_p = __shfl_sync(dbt::FULL_MASK, lp, 0);
    const int32_t total = __shfl_sync(dbt::FULL_MASK, sum, nspan - 1);
    const int32_t end_p = __shfl_sync(dbt::FULL_MASK, hp, nspan - 1);
    if (k == 0) {  // with no overflow the kept keys are rows [first_b, first_b + total)
      bnd[0] = first_b;
      bnd[1] = min(total, nb - first_b);
      bnd[2] = first_p;
      bnd[3] = end_p;
      any_over = overs != 0;
    }
  }
  __syncthreads();
  // the thread's first probe row, read while the build keys are staged
  int32_t i = bnd[2] + threadIdx.x;
  int64_t k = -1;
  uint32_t p = 0;
  if (i < bnd[3]) {
    k = (int64_t)__ldg(p_bucket + i) - b0;
    p = __ldg(p_key + i);
  }
  if (!any_over) {  // the span's build rows, one coalesced range
    const uint32_t* src = b_key + bnd[0];
    for (int32_t t = threadIdx.x; t < bnd[1]; t += blockDim.x) keys[t] = __ldg(src + t);
  } else {
    for (int32_t k = 0; k < nspan; ++k) {
      if (off[k] < 0) continue;
      const uint32_t* src = b_key + clamp_row(__ldg(st_b + b0 + k), nb);
      for (int32_t t = threadIdx.x; t < cnt[k]; t += blockDim.x) keys[off[k] + t] = __ldg(src + t);
    }
  }
  __syncthreads();
  while (i < bnd[3]) {
    bool h = false;
    if (k >= 0 && k < nspan && off[k] >= 0) {
      const uint32_t* bk = keys + off[k];
      for (int32_t j = 0; j < cnt[k]; ++j) h |= bk[j] == p;
    }
    hit[i] = h;
    i += blockDim.x;
    if (i < bnd[3]) {
      k = (int64_t)__ldg(p_bucket + i) - b0;
      p = __ldg(p_key + i);
    }
  }
  // bucket B, the inactive rows
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)clamp_row(__ldg(st_p + nbuckets), np) +
                   (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < np; t += step)
    hit[t] = false;
}

}  // namespace

// b_bucket i32[nb] and p_bucket i32[np]: non-decreasing, in [0, nbuckets];
// b_key u32[nb], p_key u32[np] beside them; span buckets a compare block of
// `threads`; starts i32[2 * (nbuckets + 2)] scratch; hit bool[np]; ovf one
// i32.
DBT_API int dbt_bucket_probe(const void* b_bucket, const void* b_key, int64_t nb,
                             const void* p_bucket, const void* p_key, int64_t np,
                             int64_t nbuckets, int cap, int span, int threads, void* starts,
                             void* hit, void* ovf, void* stream) {
  if (nb < 0 || nb > INT32_MAX || np < 0 || np > INT32_MAX || nbuckets < 1 ||
      nbuckets >= INT32_MAX || cap < 0 || cap > MAX_CAP || span < 1 || span > MAX_SPAN ||
      threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(ovf, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned build_blocks = dbt::blocks_for(nb + 1, STARTS_THREADS * STARTS_ROWS);
  const bool vec = reinterpret_cast<uintptr_t>(b_bucket) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(p_bucket) % 16 == 0;
  starts_kernel<<<build_blocks + dbt::blocks_for(np + 1, STARTS_THREADS * STARTS_ROWS),
                  STARTS_THREADS, 0, s>>>(
      static_cast<const int32_t*>(b_bucket), (int32_t)nb, static_cast<const int32_t*>(p_bucket),
      (int32_t)np, (int32_t)nbuckets, build_blocks, vec, static_cast<int32_t*>(starts));
  DBT_CHECK_LAUNCH();
  const size_t smem = 4 * (size_t)span * (size_t)(cap > 0 ? cap : 1);
  compare_kernel<<<dbt::blocks_for(nbuckets, span), threads, smem, s>>>(
      static_cast<const int32_t*>(starts), static_cast<const uint32_t*>(b_key), (int32_t)nb,
      static_cast<const int32_t*>(p_bucket), static_cast<const uint32_t*>(p_key), (int32_t)np,
      (int32_t)nbuckets, cap, span, static_cast<bool*>(hit), static_cast<int32_t*>(ovf));
  DBT_CHECK_LAUNCH();
  return 0;
}
