// K22: the range destination of the distributed sort.
//
// Replaces the JAX package's _lex_ge and the sum over its [N, S] matrix
// (parallel/dist_ops.py:312-326,380): a row's destination is the number of
// splitters its key is greater than or equal to, comparing the key's u32
// words lexicographically, most significant first, unsigned.  A key is 1-4
// words: recid or num, or (num and) the first string words, as
// dist_sort's npart_words sets them (dist_ops.py:347-349).  The JAX form
// builds the n x S matrix in device memory; here the S splitters (ndev - 1 of
// them) sit in shared memory and a thread compares its rows' keys with each
// in turn, so nothing of size n x S exists.  The splitters come sorted from
// the sample sort, but the count does not rely on it: every splitter is
// compared, as the JAX sum does.
//
// Bound on the H100: bytes, the key words read once (4-16 B a row) and the
// destination written (4 B a row); the compares are S a row.  So the design
// moves those bytes in as few, wide accesses as the layout allows and does
// nothing else on the card:
// - the wrapper launches this kernel and nothing else: the splitter columns
//   come as device pointers (with their strides), and each block copies them
//   into shared memory once, word-major;
// - the compare is compiled for the key's width (NW = 1-4, dispatched here)
//   in the branch-free form of lex_ge: gt |= eq & (w > s); eq &= (w == s);
// - where every key column is contiguous and 16-byte aligned (num, recid),
//   a thread takes 4 rows by one 16-byte load a word and writes their 4
//   destinations as one 16-byte store; the thread past the last whole group
//   takes the n % 4 rows of the tail one by one.  Strided columns (string
//   words of the row-major strw matrix) take ROWS rows a thread,
//   all loads issued before the first compare.
// kernels/dist_plan.py chooses the path and the grid (range_plan); the entry
// below refuses a plan the kernels were not built for.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // kernels/dist_plan.py RANGE_THREADS
constexpr int MAX_WORDS = 4;   // kernels/dist_plan.py RANGE_MAX_WORDS
constexpr int ROWS = 4;        // kernels/dist_plan.py RANGE_ROWS: rows a thread, one int4 a word
static_assert(ROWS == 4, "the vector path reads a thread's rows as one uint4 a word");

struct Cols {
  const uint32_t* ptr[MAX_WORDS];
  int64_t stride[MAX_WORDS];
};

// The splitters into shared memory, word-major: s_spl[k * ns + s].
template <int NW>
__device__ __forceinline__ void load_splitters(const Cols& spl, int32_t ns, uint32_t* s_spl) {
#pragma unroll
  for (int k = 0; k < NW; ++k)
    for (int32_t s = threadIdx.x; s < ns; s += THREADS)
      s_spl[k * ns + s] = __ldg(spl.ptr[k] + s * spl.stride[k]);
  __syncthreads();
}

// cnt[r] = the splitters key[r] is >= to, each splitter word read once for
// the R rows.
template <int NW, int R>
__device__ __forceinline__ void count_ge(const uint32_t (&key)[R][NW], const uint32_t* s_spl,
                                         int32_t ns, int32_t (&cnt)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) cnt[r] = 0;
  for (int32_t s = 0; s < ns; ++s) {
    uint32_t b[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) b[k] = s_spl[k * ns + s];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool gt = false, eq = true;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        gt |= eq & (key[r][k] > b[k]);
        eq &= key[r][k] == b[k];
      }
      cnt[r] += (int32_t)(gt | eq);
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
    range_dest_vec(Cols w, int64_t n, Cols spl, int32_t ns, int32_t* __restrict__ dest) {
  extern __shared__ uint32_t s_spl[];
  load_splitters<NW>(spl, ns, s_spl);
  const int64_t grp = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t full = n / ROWS;
  if (grp < full) {
    uint32_t key[ROWS][NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(w.ptr[k]) + grp);
      key[0][k] = v.x;
      key[1][k] = v.y;
      key[2][k] = v.z;
      key[3][k] = v.w;
    }
    int32_t cnt[ROWS];
    count_ge<NW, ROWS>(key, s_spl, ns, cnt);
    reinterpret_cast<int4*>(dest)[grp] = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
  } else if (grp == full) {  // the tail: n % 4 rows, one by one
    for (int64_t i = full * ROWS; i < n; ++i) {
      uint32_t key[1][NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) key[0][k] = __ldg(w.ptr[k] + i);
      int32_t cnt[1];
      count_ge<NW, 1>(key, s_spl, ns, cnt);
      dest[i] = cnt[0];
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(THREADS)
    range_dest_scalar(Cols w, int64_t n, Cols spl, int32_t ns, int32_t* __restrict__ dest) {
  extern __shared__ uint32_t s_spl[];
  load_splitters<NW>(spl, ns, s_spl);
  // a block owns THREADS * ROWS consecutive rows; row r of a thread
  // lies r * THREADS past its first, so each load step of a warp is one run
  const int64_t base = (int64_t)blockIdx.x * THREADS * ROWS + threadIdx.x;
  uint32_t key[ROWS][NW];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t i = base + (int64_t)r * THREADS;
#pragma unroll
    for (int k = 0; k < NW; ++k) key[r][k] = i < n ? __ldg(w.ptr[k] + i * w.stride[k]) : 0u;
  }
  int32_t cnt[ROWS];
  count_ge<NW, ROWS>(key, s_spl, ns, cnt);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int64_t i = base + (int64_t)r * THREADS;
    if (i < n) dest[i] = cnt[r];
  }
}

template <int NW>
int launch(const Cols& w, int64_t n, const Cols& spl, int32_t ns, int32_t* dest, bool vec,
           int64_t blocks, cudaStream_t st) {
  const size_t bytes = (size_t)(NW * ns > 0 ? NW * ns : 1) * 4u;
  const void* fn = vec ? (const void*)range_dest_vec<NW> : (const void*)range_dest_scalar<NW>;
  if (bytes > 48 * 1024) {
    cudaError_t ce =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (ce != cudaSuccess) return (int)ce;
  }
  if (vec)
    range_dest_vec<NW><<<(unsigned)blocks, THREADS, bytes, st>>>(w, n, spl, ns, dest);
  else
    range_dest_scalar<NW><<<(unsigned)blocks, THREADS, bytes, st>>>(w, n, spl, ns, dest);
  DBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// words: nw (1-4) device pointers (host array) to u32 columns of n rows with
// their row strides; splitters: nw device pointers to u32 columns of ns
// rows with their strides, splitter s being (splitters[0][s], ...,
// splitters[nw-1][s]); dest i32[n].  The plan (kernels/dist_plan.py
// range_plan): vec (16-byte loads of contiguous, aligned columns) and the
// blocks.
DBT_API int dbt_range_dest(const void* const* words, const int64_t* strides, int nw, int64_t n,
                           const void* const* splitters, const int64_t* spl_strides, int64_t ns,
                           void* dest, int vec, int64_t blocks, void* stream) {
  if (nw < 1 || nw > MAX_WORDS || n < 0 || n > INT32_MAX || ns < 0 ||
      (size_t)(nw * ns) * 4u > 232448u)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (blocks < 1 || blocks > INT32_MAX || blocks * THREADS * ROWS < n)
    return (int)cudaErrorInvalidValue;
  Cols w, spl;
  for (int k = 0; k < MAX_WORDS; ++k) {
    w.ptr[k] = k < nw ? static_cast<const uint32_t*>(words[k]) : nullptr;
    w.stride[k] = k < nw ? strides[k] : 0;
    spl.ptr[k] = k < nw ? static_cast<const uint32_t*>(splitters[k]) : nullptr;
    spl.stride[k] = k < nw ? spl_strides[k] : 0;
    if (vec && k < nw && (w.stride[k] != 1 || reinterpret_cast<uintptr_t>(w.ptr[k]) % 16))
      return (int)cudaErrorInvalidValue;
  }
  if (vec && reinterpret_cast<uintptr_t>(dest) % 16) return (int)cudaErrorInvalidValue;
  int32_t* d = static_cast<int32_t*>(dest);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 1: return launch<1>(w, n, spl, (int32_t)ns, d, vec != 0, blocks, st);
    case 2: return launch<2>(w, n, spl, (int32_t)ns, d, vec != 0, blocks, st);
    case 3: return launch<3>(w, n, spl, (int32_t)ns, d, vec != 0, blocks, st);
    default: return launch<4>(w, n, spl, (int32_t)ns, d, vec != 0, blocks, st);
  }
}
