// K22: the range destination of the distributed sort.
//
// Replaces the JAX package's _lex_ge and the sum over its [N, S] matrix
// (parallel/dist_ops.py:312-326,380): a row's destination is the number of
// splitters its key is greater than or equal to, comparing the key's u32
// words lexicographically, most significant first, unsigned.  A key is 1-4
// words: recid or num, or (num and) the first string words, as
// dist_sort's npart_words sets them (dist_ops.py:347-349).  The JAX form
// builds the n x S matrix in device memory; here the S splitters (ndev - 1 of
// them, word-major) sit in shared memory and one thread a row compares its
// key with each in turn, so nothing of size n x S exists.  The splitters
// come sorted from the sample sort, but the count does not rely on it: every
// splitter is compared, as the JAX sum does.
//
// Bound on the H100: bytes, the key words read once (4-16 B a row) and the
// destination written (4 B a row); the compares are S a row.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_WORDS = 4;  // kernels/dist_plan.py RANGE_MAX_WORDS

struct Words {
  const uint32_t* ptr[MAX_WORDS];
  int64_t stride[MAX_WORDS];
  int count;
};

__global__ void __launch_bounds__(THREADS)
    range_dest_kernel(Words w, int64_t n, const uint32_t* __restrict__ splitters, int32_t ns,
                      int32_t* __restrict__ dest) {
  extern __shared__ uint32_t s_spl[];  // [count][ns]
  for (int32_t j = threadIdx.x; j < w.count * ns; j += blockDim.x) s_spl[j] = splitters[j];
  __syncthreads();
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    uint32_t key[MAX_WORDS];
#pragma unroll
    for (int k = 0; k < MAX_WORDS; ++k) key[k] = k < w.count ? __ldg(w.ptr[k] + i * w.stride[k]) : 0u;
    int32_t cnt = 0;
    for (int32_t s = 0; s < ns; ++s) {
      int ge = 1;  // all words equal: greater or equal
#pragma unroll
      for (int k = 0; k < MAX_WORDS; ++k) {
        if (k < w.count) {
          const uint32_t b = s_spl[k * ns + s];
          if (key[k] != b) {
            ge = key[k] > b;
            break;
          }
        }
      }
      cnt += ge;
    }
    dest[i] = cnt;
  }
}

}  // namespace

// words: nw (1-4) device pointers (host array) to u32 columns of n rows with
// their row strides; splitters u32[nw * ns], word-major; dest i32[n].
DBT_API int dbt_range_dest(const void* const* words, const int64_t* strides, int nw, int64_t n,
                           const void* splitters, int64_t ns, void* dest, void* stream) {
  if (nw < 1 || nw > MAX_WORDS || n < 0 || ns < 0 || (size_t)(nw * ns) * 4u > 232448u)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Words w;
  w.count = nw;
  for (int k = 0; k < MAX_WORDS; ++k) {
    w.ptr[k] = k < nw ? static_cast<const uint32_t*>(words[k]) : nullptr;
    w.stride[k] = k < nw ? strides[k] : 0;
  }
  const size_t bytes = (size_t)(nw * ns > 0 ? nw * ns : 1) * 4u;
  if (bytes > 48 * 1024) {
    cudaError_t ce = cudaFuncSetAttribute((const void*)range_dest_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (ce != cudaSuccess) return (int)ce;
  }
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;  // each block copies the splitters once
  range_dest_kernel<<<(unsigned)blocks, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      w, n, static_cast<const uint32_t*>(splitters), (int32_t)ns, static_cast<int32_t*>(dest));
  DBT_CHECK_LAUNCH();
  return 0;
}
