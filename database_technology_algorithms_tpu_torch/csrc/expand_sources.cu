// K14: the expansion sources.
//
// Replaces the JAX package's source search in materialize_field3_device
// (ops/hash_join.py:682-686): output row i of a segmented expansion, which
// emits probe row j mult[j] times, comes from probe row
// searchsorted(c, i, 'right'), the first j with c[j] > i, where c is the
// inclusive int32 cumsum of mult; rows at or past min(total, cap) take the
// fill row nprobe.
//
// Bound on the H100: bytes.  Per output row it writes one int32; c is read
// by a binary search of log2(nprobe) steps, which at the path's sizes sits
// in the 50 MB L2 after the first rows touch it.  One thread an output row:
// the work per output row is the same however skewed mult is (a design in
// which each probe row writes its own range of outputs would serialise on
// one heavy row).  total is read on the device, so no count comes back to
// the host.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    expand_sources_kernel(const int32_t* __restrict__ c, int32_t nprobe,
                          const int32_t* __restrict__ total, int32_t cap,
                          int32_t* __restrict__ src) {
  const int32_t i = (int32_t)(blockIdx.x * THREADS + threadIdx.x);
  if (i >= cap) return;
  if (i >= *total) {
    src[i] = nprobe;
    return;
  }
  // c is non-decreasing; find the first j with c[j] > i (c[nprobe-1] =
  // total > i, so j < nprobe)
  int32_t lo = 0, hi = nprobe;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(c + mid) > i)
      hi = mid;
    else
      lo = mid + 1;
  }
  src[i] = lo;
}

}  // namespace

// c i32[nprobe], the inclusive cumsum of the multiplicities; total: one i32
// on the device (c[nprobe - 1], or 0 when nprobe is 0); src i32[cap].
DBT_API int dbt_expand_sources(const void* c, int64_t nprobe, const void* total, int64_t cap,
                               void* src, void* stream) {
  if (nprobe < 0 || nprobe > INT32_MAX || cap < 0 || cap > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return 0;
  expand_sources_kernel<<<dbt::blocks_for(cap, THREADS), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(c), (int32_t)nprobe, static_cast<const int32_t*>(total),
      (int32_t)cap, static_cast<int32_t*>(src));
  DBT_CHECK_LAUNCH();
  return 0;
}
