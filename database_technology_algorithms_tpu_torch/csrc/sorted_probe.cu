// K15: the sorted-key probe.
//
// Replaces the probe of the JAX package's hash_join_count_u32
// (ops/fastpath.py:101-104): jnp.searchsorted of every probe key in the
// sorted live build keys (a U32_MAX tail past the live count), the clipped
// take, the gate pos < build_count and the probe-count gate.  Per probe row
// i: hit = i is live and some live build key equals its key; mult = hit as
// int32.
//
// Bound on the H100: bytes.  A probe row reads its key and writes a bool and
// an int32 (9 B); its binary search reads log2(count) build keys, whose top
// levels every search shares and which at the path's sizes (1M or 8M keys,
// 4 or 32 MB) sit in the 50 MB L2.  One thread a probe row, neighbouring
// threads on neighbouring keys.  The order is unsigned: keys are read as
// uint32_t.  The search runs over the live prefix [0, count) only, where the
// keys are sorted; lower_bound there is the JAX package's searchsorted over
// the masked array, clipped to count, so a live 0xFFFFFFFF key at count - 1
// matches and the padding never does.  The counts are read on the device
// when the caller gives them there, so nothing comes back to the host.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    sorted_probe_kernel(const uint32_t* __restrict__ skey, int32_t nb,
                        const int32_t* __restrict__ bcnt_dev, int32_t bcnt_host,
                        const uint32_t* __restrict__ pkey, int32_t np,
                        const int32_t* __restrict__ pcnt_dev, int32_t pcnt_host,
                        bool* __restrict__ hit, int32_t* __restrict__ mult) {
  const int32_t i = (int32_t)(blockIdx.x * THREADS + threadIdx.x);
  if (i >= np) return;
  int32_t bc = bcnt_dev ? *bcnt_dev : bcnt_host;
  bc = bc < 0 ? 0 : (bc > nb ? nb : bc);
  const int32_t pc = pcnt_dev ? *pcnt_dev : pcnt_host;
  bool h = false;
  if (i < pc) {
    const uint32_t p = pkey[i];
    int32_t lo = 0, hi = bc;
    while (lo < hi) {
      const int32_t mid = lo + ((hi - lo) >> 1);
      if (__ldg(skey + mid) < p)
        lo = mid + 1;
      else
        hi = mid;
    }
    h = lo < bc && __ldg(skey + lo) == p;
  }
  hit[i] = h;
  mult[i] = h ? 1 : 0;
}

}  // namespace

// skey: u32[nb], sorted (unsigned) over its first count rows; bcnt: one i32
// on the device, or null and bcnt_host; pkey: u32[np]; pcnt likewise (np
// when every probe row is live); hit bool[np], mult i32[np].
DBT_API int dbt_sorted_probe(const void* skey, int64_t nb, const void* bcnt, int64_t bcnt_host,
                             const void* pkey, int64_t np, const void* pcnt, int64_t pcnt_host,
                             void* hit, void* mult, void* stream) {
  if (nb < 0 || nb > INT32_MAX || np < 0 || np > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (np == 0) return 0;
  sorted_probe_kernel<<<dbt::blocks_for(np, THREADS), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(skey), (int32_t)nb, static_cast<const int32_t*>(bcnt),
      (int32_t)bcnt_host, static_cast<const uint32_t*>(pkey), (int32_t)np,
      static_cast<const int32_t*>(pcnt), (int32_t)pcnt_host, static_cast<bool*>(hit),
      static_cast<int32_t*>(mult));
  DBT_CHECK_LAUNCH();
  return 0;
}
