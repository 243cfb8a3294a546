// K4: record gather with fill.
//
// Replaces the JAX package's RecordBatch.take_fill (batch.py:220), four
// jnp.take(mode="fill") gathers, on the pipeline's gather route
// (models/pipeline.py:386-394): out[i] = row idx[i] across recid, num, the K
// string words and valid.  An index outside [-n, n) gives a zero row with
// valid = false; a negative index counts from the end, as jnp.take does.
//
// Bound on the H100: bytes.  Per output row it reads the 4-byte index and
// (3 + K) words of the source row (valid as 1 byte) and writes as many.
// One thread per (row, column) with the row's columns on neighbouring
// threads, so the K string words of a row are read and written by
// consecutive threads; the index is re-read by each of its row's threads
// from L1/L2, not from device memory.
#include "common.cuh"

namespace {

__global__ void take_fill_kernel(const int32_t* idx, int64_t m, int64_t n, int k,
                                 const uint32_t* recid, const uint32_t* num,
                                 const uint32_t* strw, const uint8_t* valid,
                                 uint32_t* o_recid, uint32_t* o_num, uint32_t* o_strw,
                                 uint8_t* o_valid) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t width = (int64_t)k + 3;
  if (t >= m * width) return;
  const int64_t row = t / width;
  const int col = (int)(t - row * width);
  int64_t j = idx[row];
  if (j < 0) j += n;
  const bool in = j >= 0 && j < n;
  if (col == 0) {
    o_recid[row] = in ? recid[j] : 0u;
  } else if (col == 1) {
    o_num[row] = in ? num[j] : 0u;
  } else if (col == 2) {
    o_valid[row] = in ? valid[j] : (uint8_t)0;
  } else {
    const int c = col - 3;
    o_strw[row * k + c] = in ? strw[j * k + c] : 0u;
  }
}

}  // namespace

// idx i32[m]; source columns of n rows (strw u32[n, k]); outputs of m rows.
DBT_API int dbt_take_fill(const void* idx, int64_t m, int64_t n, int k,
                          const void* recid, const void* num, const void* strw, const void* valid,
                          void* o_recid, void* o_num, void* o_strw, void* o_valid,
                          void* stream) {
  if (m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t threads = m * ((int64_t)k + 3);
  take_fill_kernel<<<dbt::blocks_for(threads, 256), 256, 0, st>>>(
      static_cast<const int32_t*>(idx), m, n, k,
      static_cast<const uint32_t*>(recid), static_cast<const uint32_t*>(num),
      static_cast<const uint32_t*>(strw), static_cast<const uint8_t*>(valid),
      static_cast<uint32_t*>(o_recid), static_cast<uint32_t*>(o_num),
      static_cast<uint32_t*>(o_strw), static_cast<uint8_t*>(o_valid));
  DBT_CHECK_LAUNCH();
  return 0;
}
