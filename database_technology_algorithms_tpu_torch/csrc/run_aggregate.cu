// K13: the run aggregate.
//
// Replaces the JAX package's _run_aggregates tail (ops/aggregate.py:46-75):
// over rows in key order, the count, the u32 sum, the unsigned min and the
// unsigned max of each run of equal keys among the active rows, written
// group-major, and the number of groups.  There it is two cumsums, a
// segmented min, a segmented max, a four-word compaction of the run ends
// and neighbour differences: six passes over the sorted rows.
//
// Group g is the g-th run of new_run = active & ~adj.  The wrapper hands in
// incl, the inclusive K2 cumsum of new_run, so row i belongs to group
// incl[i] - 1 (rows before the first run start to none), and the number of
// groups is incl[n - 1].  Inactive rows add the identities.
//
// Bound on the H100: bytes.  Per row it reads a 1-byte flag, the 4-byte
// group id and one (num) or four (partials) 4-byte measures, and per group
// writes four words; a handful of integer operations a row.  Each warp owns
// a span of SPAN consecutive rows and walks it 32 rows at a time, one row a
// lane (coalesced): a segmented inclusive scan by group id with warp
// shuffles sums each group's rows within the 32, and a warp-uniform carry
// takes the last group on to the next 32.  A group that starts and ends
// inside the span is written with plain stores; the span's first group and
// its last may continue into a neighbour's span, and commit with atomicAdd
// (count and sum, which wrap mod 2^32 either way) and atomicMin/atomicMax on
// unsigned, into columns the entry point pre-fills with the identities.
// Integer atomics are exact and commutative, so the result does not depend
// on the order the spans commit in, and each measure takes at most two
// atomics a span, however long a group is.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;                 // warps a block
constexpr int CHUNKS = 8;                // 32-row steps a warp span
constexpr int SPAN = 32 * CHUNKS;        // rows a warp (kernels/run_aggregate.py SPAN_ROWS)
constexpr int32_t NO_GROUP = INT32_MAX;  // a lane past the span's end

struct Agg {
  uint32_t c, s, mn, mx;
  int act;  // an active row contributed
};

__device__ __forceinline__ Agg identity() { return {0u, 0u, 0xFFFFFFFFu, 0u, 0}; }

__device__ __forceinline__ void combine(Agg& a, const Agg& b) {
  a.c += b.c;
  a.s += b.s;
  a.mn = min(a.mn, b.mn);
  a.mx = max(a.mx, b.mx);
  a.act |= b.act;
}

__device__ __forceinline__ Agg shfl(const Agg& v, int src) {
  return {__shfl_sync(dbt::FULL_MASK, v.c, src), __shfl_sync(dbt::FULL_MASK, v.s, src),
          __shfl_sync(dbt::FULL_MASK, v.mn, src), __shfl_sync(dbt::FULL_MASK, v.mx, src),
          __shfl_sync(dbt::FULL_MASK, v.act, src)};
}

__device__ __forceinline__ Agg shfl_up(const Agg& v, int d) {
  return {__shfl_up_sync(dbt::FULL_MASK, v.c, d), __shfl_up_sync(dbt::FULL_MASK, v.s, d),
          __shfl_up_sync(dbt::FULL_MASK, v.mn, d), __shfl_up_sync(dbt::FULL_MASK, v.mx, d),
          __shfl_up_sync(dbt::FULL_MASK, v.act, d)};
}

struct Args {
  const uint8_t* active;
  const int32_t* incl;
  const uint32_t* v[4];  // num alone, or count, sum, min, max
  uint32_t* out[4];      // count, sum, min, max, each [n]
  int32_t* n_groups;
  int64_t n;
};

// Write group g's aggregate: by atomics where another span may hold part of
// it, by stores where this span holds all of it.
__device__ __forceinline__ void commit(const Args& a, int32_t g, const Agg& v, bool atomic) {
  if (!v.act || g < 0 || g == NO_GROUP) return;
  if (atomic) {
    atomicAdd(a.out[0] + g, v.c);
    atomicAdd(a.out[1] + g, v.s);
    atomicMin(a.out[2] + g, v.mn);
    atomicMax(a.out[3] + g, v.mx);
  } else {
    a.out[0][g] = v.c;
    a.out[1][g] = v.s;
    a.out[2][g] = v.mn;
    a.out[3][g] = v.mx;
  }
}

// SINGLE: one measure (num) gives sum, min and max, and each active row
// counts 1 (group_aggregate_impl); otherwise four partial columns
// (combine_group_aggregate_impl).
template <bool SINGLE>
__global__ void __launch_bounds__(WARPS * 32) run_aggregate_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.n_groups = a.incl[a.n - 1];
  const int64_t s0 = ((int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5)) * SPAN;
  if (s0 >= a.n) return;
  const int64_t s1 = s0 + SPAN < a.n ? s0 + SPAN : a.n;
  const int32_t first = a.incl[s0] - 1;  // the span's first group
  int32_t cg = first;                    // the carry: the open group and its partial
  Agg carry = identity();
  for (int64_t base = s0; base < s1; base += 32) {
    const int64_t i = base + lane;
    const int last = s1 - base > 32 ? 31 : (int)(s1 - 1 - base);  // the span's last lane here
    int32_t g = NO_GROUP;
    Agg v = identity();
    if (i < s1) {
      g = a.incl[i] - 1;
      if (a.active[i]) {
        if (SINGLE) {
          const uint32_t x = a.v[0][i];
          v = {1u, x, x, x, 1};
        } else {
          v = {a.v[0][i], a.v[1][i], a.v[2][i], a.v[3][i], 1};
        }
      }
    }
    // the carry joins the first 32 rows' first group, or ended before them
    const int32_t g0 = __shfl_sync(dbt::FULL_MASK, g, 0);
    if (g0 == cg) {
      if (lane == 0) combine(v, carry);
    } else if (lane == 0) {
      commit(a, cg, carry, cg == first);
    }
    // segmented inclusive scan by group id (ids never decrease along rows)
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t go = __shfl_up_sync(dbt::FULL_MASK, g, d);
      const Agg o = shfl_up(v, d);
      if (lane >= d && go == g) combine(v, o);
    }
    const int32_t gn = __shfl_down_sync(dbt::FULL_MASK, g, 1);
    // a group that ends before the last lane ends inside the span
    if (lane < last && gn != g) commit(a, g, v, g == first);
    cg = __shfl_sync(dbt::FULL_MASK, g, last);
    carry = shfl(v, last);
  }
  if (lane == 0) commit(a, cg, carry, true);  // may continue into the next span
}

}  // namespace

// active u8[n]; incl i32[n], the inclusive cumsum of active & ~adj; vals:
// nvals (1 or 4) device pointers to u32 columns of n rows; out: [4, n] u32,
// group-major count, sum, min, max; n_groups: one i32 on the device.  The
// columns are pre-filled here with 0, 0, 0xFFFFFFFF, 0 in the stream.
DBT_API int dbt_run_aggregate(const void* active, const void* incl, const void* const* vals,
                              int nvals, int64_t n, void* out, void* n_groups, void* stream) {
  if ((nvals != 1 && nvals != 4) || n < 0 || n > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(n_groups, 0, sizeof(int32_t), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  uint32_t* o = static_cast<uint32_t*>(out);
  err = cudaMemsetAsync(o, 0, 4 * sizeof(uint32_t) * n, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(o + 2 * n, 0xFF, sizeof(uint32_t) * n, st);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.active = static_cast<const uint8_t*>(active);
  a.incl = static_cast<const int32_t*>(incl);
  for (int k = 0; k < 4; ++k) {
    a.v[k] = static_cast<const uint32_t*>(vals[k < nvals ? k : 0]);
    a.out[k] = o + k * n;
  }
  a.n_groups = static_cast<int32_t*>(n_groups);
  a.n = n;
  const unsigned grid = dbt::blocks_for(n, (int64_t)WARPS * SPAN);
  if (nvals == 1)
    run_aggregate_kernel<true><<<grid, WARPS * 32, 0, st>>>(a);
  else
    run_aggregate_kernel<false><<<grid, WARPS * 32, 0, st>>>(a);
  DBT_CHECK_LAUNCH();
  return 0;
}
