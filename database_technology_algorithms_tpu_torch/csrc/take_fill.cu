// K4: record gather with fill, on the row-move engine of rowmove.cuh.
//
// Replaces the JAX package's RecordBatch.take_fill (batch.py:220), four
// jnp.take(mode="fill") gathers, on the pipeline's gather route
// (models/pipeline.py:386-394): out[i] = row idx[i] across recid, num, the K
// string words and valid.  An index outside [-n, n) gives a zero row with
// valid = false; a negative index counts from the end, as jnp.take does.
// With a live count, positions at or past it are fill rows too: the JAX
// package's take_fill of where(arange(m) < count, idx, n).
//
// Bound on the H100: bytes.  Per output row it reads the 4-byte index, and
// for a live row (3 + K) words of the source row (valid as 1 byte), and
// writes as many.  A block owns up to 1024 output rows.  One thread a row
// reads its index once and writes recid, num and valid, so consecutive
// threads write consecutive words (bytes for valid) and no thread divides
// by the row's width; the string words then move as rows of K / V vectors
// of V words (rowmove::move_span).  Fill rows (72% of the staged run's
// output) read nothing.  Where a row's string words are one vector (K = 2
// on the main path, 8 bytes), the row's own thread moves them beside the
// one-word columns: no hand-off through shared memory and no barrier, so
// the index load and one round of gathers are the only dependent steps.
// What is left is the layout: a live row reads four columns, four random
// sectors, for 17 bytes (PERF.md).
#include "rowmove.cuh"

namespace {

using namespace dbt::rowmove;

struct TakeArgs {
  const int32_t* idx;
  int32_t m, n;
  const uint32_t* recid;
  const uint32_t* num;
  const void* strw;
  const uint8_t* valid;
  uint32_t* o_recid;
  uint32_t* o_num;
  void* o_strw;
  uint8_t* o_valid;
  const int32_t* count;
  int32_t count_host;
  int32_t rows;  // rows a block owns
  Divider dv;    // string vectors a row
};

template <int V, bool ROW_VECTOR>
__global__ void __launch_bounds__(THREADS) take_fill_kernel(TakeArgs a) {
  using T = typename Vec<V>::T;
  __shared__ int32_t s_src[MAX_ROWS];
  const uint32_t row0 = blockIdx.x * (uint32_t)a.rows;
  const int rows = min(a.rows, a.m - (int)row0);
  const int32_t cnt = live_count(a.count, a.count_host);
  // one thread a row: the index, normalized and checked once
  int32_t src[ROWS_PER_THREAD];
#pragma unroll
  for (int u = 0; u < ROWS_PER_THREAD; ++u) {
    const int i = threadIdx.x + u * THREADS;
    src[u] = -1;
    if (i < rows) {
      const int32_t pos = (int32_t)row0 + i;
      int32_t j = a.idx[pos];
      if (j < 0) j += a.n;  // no overflow: j < 0 and n < 2^31
      if (pos < cnt && j >= 0 && j < a.n) src[u] = j;
      if (!ROW_VECTOR) s_src[i] = src[u];
    }
  }
  // the one-word columns (and a one-vector row): every load in flight
  // before the stores
  const T* strw = static_cast<const T*>(a.strw);
  T* o_strw = static_cast<T*>(a.o_strw);
  uint32_t rv[ROWS_PER_THREAD], nv[ROWS_PER_THREAD];
  uint8_t vv[ROWS_PER_THREAD];
  T sv[ROWS_PER_THREAD];
#pragma unroll
  for (int u = 0; u < ROWS_PER_THREAD; ++u) {
    const bool in = src[u] >= 0;
    rv[u] = in ? a.recid[src[u]] : 0u;
    nv[u] = in ? a.num[src[u]] : 0u;
    vv[u] = in ? a.valid[src[u]] : (uint8_t)0;
    sv[u] = Vec<V>::zero();
    if (ROW_VECTOR && in) sv[u] = strw[src[u]];
  }
#pragma unroll
  for (int u = 0; u < ROWS_PER_THREAD; ++u) {
    const int i = threadIdx.x + u * THREADS;
    if (i < rows) {
      const int32_t pos = (int32_t)row0 + i;
      a.o_recid[pos] = rv[u];
      a.o_num[pos] = nv[u];
      a.o_valid[pos] = vv[u];
      if (ROW_VECTOR) o_strw[pos] = sv[u];
    }
  }
  if (ROW_VECTOR) return;
  __syncthreads();
  move_span<V, true>(strw, o_strw, s_src, row0, (uint32_t)rows, a.dv);
}

template <int V>
void launch(unsigned grid, cudaStream_t st, const TakeArgs& a) {
  if (a.dv.d == 1)
    take_fill_kernel<V, true><<<grid, THREADS, 0, st>>>(a);
  else
    take_fill_kernel<V, false><<<grid, THREADS, 0, st>>>(a);
}

}  // namespace

// idx i32[m]; source columns of n rows (strw u32[n, k]); outputs of m rows.
// count: a device int32 live count, or null for `count_host`.  vec: the
// access width in words (4, 2 or 1) dividing k and the alignment of strw and
// o_strw; rows: the rows a block owns (kernels/rowmove_plan.py).
DBT_API int dbt_take_fill(const void* idx, int64_t m, int64_t n, int k,
                          const void* recid, const void* num, const void* strw, const void* valid,
                          void* o_recid, void* o_num, void* o_strw, void* o_valid,
                          const void* count, int64_t count_host, int vec, int rows,
                          void* stream) {
  if (m <= 0) return 0;
  if (m > INT32_MAX || n < 0 || n > INT32_MAX || k < 0 || rows < 1 || rows > MAX_ROWS ||
      (vec != 1 && vec != 2 && vec != 4) || k % vec != 0 || !split_exact(rows, k / vec) ||
      count_host < INT32_MIN || count_host > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (misaligned(strw, vec) || misaligned(o_strw, vec)) return (int)cudaErrorMisalignedAddress;
  TakeArgs a;
  a.idx = static_cast<const int32_t*>(idx);
  a.m = (int32_t)m;
  a.n = (int32_t)n;
  a.recid = static_cast<const uint32_t*>(recid);
  a.num = static_cast<const uint32_t*>(num);
  a.strw = strw;
  a.valid = static_cast<const uint8_t*>(valid);
  a.o_recid = static_cast<uint32_t*>(o_recid);
  a.o_num = static_cast<uint32_t*>(o_num);
  a.o_strw = o_strw;
  a.o_valid = static_cast<uint8_t*>(o_valid);
  a.count = static_cast<const int32_t*>(count);
  a.count_host = (int32_t)count_host;
  a.rows = rows;
  a.dv = divider((uint32_t)(k / vec));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = dbt::blocks_for(m, rows);
  if (vec == 4)
    launch<4>(grid, st, a);
  else if (vec == 2)
    launch<2>(grid, st, a);
  else
    launch<1>(grid, st, a);
  DBT_CHECK_LAUNCH();
  return 0;
}
