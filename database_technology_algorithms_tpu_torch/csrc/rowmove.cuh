// The row-move engine of K4 (take_fill.cu, a record gather) and K12
// (row_move.cu, a tile-relative row gather or scatter).
//
// Both move rows of u32 words between a side read or written in order and a
// side addressed by an index.  Bound on the H100: bytes, each input read and
// each output written once.  What the engine does about it:
//
// - A block owns a contiguous span of rows on the ordered side (the output
//   of a gather, the input of a scatter).  One thread a row reads the row's
//   index once, coalesced, and leaves the partner row (or -1: a fill row, a
//   dropped row) in shared memory for the lanes that move the row.
// - The wide rows move as vectors of V = 4, 2 or 1 words (16-, 8-, 4-byte
//   accesses), the widest that divides the row and the alignment of both
//   base pointers (kernels/rowmove_plan.py picks V, the entry checks it, a
//   template dispatches on it).  Vector e of the span is row e / d, vector
//   e % d of it (d vectors a row): consecutive threads move consecutive
//   vectors, so the ordered side is written or read as one run and a
//   partner row is d consecutive vectors.  The split is a 32-bit
//   multiply-high by a constant of the launch, exact for e * d < 2^32
//   (the plan keeps rows * d * d below it, the entry checks it): no 64-bit
//   division a vector.
// - Fill rows read nothing; the gather writes their zeros with the same
//   vector stores.  A thread issues UNROLL vector loads before its stores,
//   so the random side has several reads in flight.
//
// Positions and rows are 32-bit (the wrappers refuse 2^31 or more); only
// the word offsets of the partner rows are 64-bit products.
#pragma once

#include "common.cuh"

namespace dbt {
namespace rowmove {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 1024;  // rows a block owns at most (rowmove_plan.MAX_BLOCK_ROWS)
constexpr int ROWS_PER_THREAD = MAX_ROWS / THREADS;
constexpr int UNROLL = 4;  // vectors a thread has in flight

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = uint32_t;
  static __device__ __forceinline__ T zero() { return 0u; }
};
template <>
struct Vec<2> {
  using T = uint2;
  static __device__ __forceinline__ T zero() { return make_uint2(0u, 0u); }
};
template <>
struct Vec<4> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0u, 0u, 0u, 0u); }
};

// Division by d, the vectors a row holds: q = umulhi(e, magic) with magic =
// floor((2^32 - 1) / d) + 1, exact for e * d < 2^32 (d = 1 is e itself).
struct Divider {
  uint32_t d;
  uint32_t magic;
};

inline Divider divider(uint32_t d) { return {d, d > 1 ? 0xFFFFFFFFu / d + 1u : 0u}; }

// The split stays exact for every vector of a span of `rows` rows.
inline bool split_exact(int rows, uint32_t d) {
  return d < (1u << 16) && (uint64_t)rows * d * d < (1ull << 32);
}

__device__ __forceinline__ uint32_t div_by(uint32_t e, Divider dv) {
  return dv.d == 1 ? e : __umulhi(e, dv.magic);
}

inline bool misaligned(const void* p, int v) {
  return reinterpret_cast<uintptr_t>(p) % (4u * (unsigned)v) != 0;
}

// The rows [row0, row0 + rows) of the ordered side, d = dv.d vectors each;
// part[r] is the partner row of row0 + r on the indexed side, or -1.
//   GATHER:  dst row row0 + r = src row part[r], zeros where part[r] < 0.
//   scatter: dst row part[r] = src row row0 + r, nothing where part[r] < 0.
template <int V, bool GATHER>
__device__ __forceinline__ void move_span(const typename Vec<V>::T* __restrict__ src,
                                          typename Vec<V>::T* __restrict__ dst,
                                          const int32_t* part, uint32_t row0, uint32_t rows,
                                          Divider dv) {
  using T = typename Vec<V>::T;
  const uint32_t total = rows * dv.d;
  for (uint32_t e0 = threadIdx.x; e0 < total; e0 += THREADS * UNROLL) {
    T val[UNROLL];
    int64_t to[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t e = e0 + (uint32_t)(u * THREADS);
      val[u] = Vec<V>::zero();
      to[u] = -1;
      if (e < total) {
        const uint32_t r = div_by(e, dv);
        const uint32_t v = e - r * dv.d;
        const int32_t p = part[r];
        const int64_t mine = (int64_t)(row0 + r) * dv.d + v;
        if (GATHER) {
          if (p >= 0) val[u] = src[(int64_t)p * dv.d + v];
          to[u] = mine;
        } else if (p >= 0) {
          val[u] = src[mine];
          to[u] = (int64_t)p * dv.d + v;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (to[u] >= 0) dst[to[u]] = val[u];
    }
  }
}

// The live count of a launch: positions at or past it are fill rows.
__device__ __forceinline__ int32_t live_count(const int32_t* count, int32_t host) {
  return count ? *count : host;
}

}  // namespace rowmove
}  // namespace dbt
