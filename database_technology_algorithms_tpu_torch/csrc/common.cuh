// Shared helpers for the port's CUDA kernels.
//
// Every entry point has a plain C interface (extern "C"), takes PyTorch's
// current stream, allocates nothing (the Python wrapper passes outputs and
// scratch), and returns the first cudaGetLastError() after its launches, or 0.
// u32 words arrive as int32 tensors and are read here as uint32_t.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DBT_API extern "C" __attribute__((visibility("default")))

#define DBT_CHECK_LAUNCH()                        \
  do {                                            \
    cudaError_t dbt_err_ = cudaGetLastError();    \
    if (dbt_err_ != cudaSuccess) return (int)dbt_err_; \
  } while (0)

namespace dbt {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// Up to MAX_WORDS (source, destination) column pairs, passed by value so
// that one launch moves several u32 columns.
constexpr int MAX_WORDS = 8;
struct WordPtrs {
  const uint32_t* src[MAX_WORDS];
  uint32_t* dst[MAX_WORDS];
  int count;
};

inline WordPtrs word_ptrs(const void* const* src, void* const* dst, int first, int count) {
  WordPtrs w;
  w.count = count;
  for (int k = 0; k < count; ++k) {
    w.src[k] = static_cast<const uint32_t*>(src[first + k]);
    w.dst[k] = static_cast<uint32_t*>(dst[first + k]);
  }
  return w;
}

inline unsigned blocks_for(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace dbt
