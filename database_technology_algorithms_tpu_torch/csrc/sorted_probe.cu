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
// an int32 (9 B).  A plain binary search over the live prefix makes 20-23
// dependent reads a probe row, each its own 32-byte sector of L2, and that
// sector traffic, not HBM, held the first form.  So the search has two
// levels (kernels/engines_plan.py probe_plan):
//   1. index_kernel writes every S-th live key (rows 0, S, 2S, ... below the
//      count) as a perfect binary search tree in breadth-first order, 2^L - 1
//      slots padded with U32_MAX (never below a probe key, so a pad acts as
//      past the end).  S = ceil(count / (2^L - 1)); the count may lie on the
//      card, so both kernels derive S from it.
//   2. search_kernel runs a persistent grid (the blocks that fit an SM);
//      each block copies the tree into shared memory once, then walks its
//      probe rows, one thread a row, neighbouring threads on neighbouring
//      rows.  The tree's walk is branch-free and a level's slots are
//      contiguous, so the shared reads spread over the banks.  It ends on
//      e, the index keys below the probe key, and on the first index key not
//      below it (a hit if equal); otherwise the key can only lie among the at
//      most S - 1 rows between index keys e - 1 and e, searched in device
//      memory, where the last levels share a line.  A load whose lanes read
//      32 lines costs the load unit a cycle a line: that, about 7 cycles a
//      probe row at the 1M shape (tree and rows), bounds the search, so the
//      search makes no read past its last step.
// The order is unsigned: keys are read as uint32_t.  Only the live prefix
// [0, count) is read, so a live 0xFFFFFFFF key at count - 1 matches and the
// padding is never read; a count of 0 gives no hit.  The search launch may
// start while the index launch ends (programmatic dependent launch): it
// waits on the index launch before its first read of the tree.
#include "common.cuh"

namespace {

constexpr int INDEX_THREADS = 256;
constexpr int MAX_LEVELS = 15;  // kernels/engines_plan.py PROBE_MAX_LEVELS

struct Stride {
  int32_t s;        // S: the index holds rows 0, S, 2S, ...
  int32_t entries;  // ceil(count / S) index keys
};

__device__ __forceinline__ int32_t clamp_count(const int32_t* dev, int32_t host, int32_t n) {
  const int32_t c = dev ? *dev : host;
  return c < 0 ? 0 : (c > n ? n : c);
}

// engines_plan.probe_stride: S = ceil(count / (2^levels - 1)), at least 1
__device__ __forceinline__ Stride stride_for(int32_t count, int levels) {
  const int32_t slots = (1 << levels) - 1;
  const int32_t s = max((int32_t)(((int64_t)count + slots - 1) / slots), 1);
  return {s, (int32_t)(((int64_t)count + s - 1) / s)};
}

// engines_plan.tree_rank: the sorted rank of breadth-first slot j >= 1
__device__ __forceinline__ int32_t tree_rank(int32_t j, int levels) {
  const int d = 31 - __clz(j);
  return ((2 * (j - (1 << d)) + 1) << (levels - 1 - d)) - 1;
}

__global__ void __launch_bounds__(INDEX_THREADS)
    index_kernel(const uint32_t* __restrict__ skey, int32_t nb,
                 const int32_t* __restrict__ bcnt_dev, int32_t bcnt_host, int levels,
                 uint32_t* __restrict__ tree) {
  // the search launch may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  const int32_t j = (int32_t)(blockIdx.x * INDEX_THREADS + threadIdx.x);
  if (j >= (1 << levels)) return;
  const Stride s = stride_for(clamp_count(bcnt_dev, bcnt_host, nb), levels);
  uint32_t v = 0xFFFFFFFFu;  // slot 0 and the pads
  if (j > 0) {
    const int32_t r = tree_rank(j, levels);
    if (r < s.entries) v = __ldg(skey + (int64_t)r * s.s);
  }
  tree[j] = v;
}

__global__ void __launch_bounds__(1024)
    search_kernel(const uint32_t* __restrict__ skey, int32_t nb,
                  const int32_t* __restrict__ bcnt_dev, int32_t bcnt_host,
                  const uint32_t* __restrict__ pkey, int32_t np,
                  const int32_t* __restrict__ pcnt_dev, int32_t pcnt_host,
                  const uint32_t* __restrict__ tree_g, int levels, bool* __restrict__ hit,
                  int32_t* __restrict__ mult) {
  extern __shared__ uint4 tree_smem[];
  uint32_t* tree = reinterpret_cast<uint32_t*>(tree_smem);
  const int32_t words = 1 << levels;
  const int32_t bc = clamp_count(bcnt_dev, bcnt_host, nb);
  const Stride s = stride_for(bc, levels);
  const int32_t pc = pcnt_dev ? *pcnt_dev : pcnt_host;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the index launch has ended
  if (words >= 4) {
    const uint4* src = reinterpret_cast<const uint4*>(tree_g);
    for (int32_t w = threadIdx.x; w < words / 4; w += blockDim.x) tree_smem[w] = src[w];
  } else if ((int32_t)threadIdx.x < words) {
    tree[threadIdx.x] = tree_g[threadIdx.x];
  }
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < np; i += step) {
    bool h = false;
    if (i < pc) {
      const uint32_t p = __ldg(pkey + i);
      int32_t j = 1;
      for (int l = 0; l < levels; ++l) j = 2 * j + (tree[j] < p ? 1 : 0);
      const int32_t e = j - words;         // index keys below p
      const int32_t k = j >> __ffs(~j);    // the slot of the first one not below it (0: none)
      if (e < s.entries && tree[k] == p) {  // e < entries: slot k holds index key e
        h = true;
      } else if (e > 0) {  // p lies strictly between index keys e - 1 and e, if anywhere
        // a lower-bound search of those rows: it reads the row of the lower
        // bound whenever that row lies inside, so a row read equal to p
        // decides, with no read after the search
        int32_t lo = (e - 1) * s.s + 1;
        int32_t n = (e < s.entries ? e * s.s : bc) - lo;
        while (n > 0) {
          const int32_t half = n >> 1;
          const uint32_t v = __ldg(skey + lo + half);
          h |= v == p;
          if (v < p) {
            lo += half + 1;
            n -= half + 1;
          } else {
            n = half;
          }
        }
      }
    }
    hit[i] = h;
    mult[i] = h ? 1 : 0;
  }
}

}  // namespace

// skey: u32[nb], sorted (unsigned) over its first count rows; bcnt: one i32
// on the device, or null and bcnt_host; pkey: u32[np]; pcnt likewise (np
// when every probe row is live); tree: u32[2^levels] scratch, 16-byte
// aligned; a search grid of `blocks` blocks of `threads`; hit bool[np],
// mult i32[np].
DBT_API int dbt_sorted_probe(const void* skey, int64_t nb, const void* bcnt, int64_t bcnt_host,
                             const void* pkey, int64_t np, const void* pcnt, int64_t pcnt_host,
                             void* tree, int levels, int threads, int blocks, void* hit,
                             void* mult, void* stream) {
  if (nb < 0 || nb > INT32_MAX || np < 0 || np > INT32_MAX || levels < 1 ||
      levels > MAX_LEVELS || threads < 32 || threads > 1024 || threads % 32 || blocks < 1 ||
      reinterpret_cast<uintptr_t>(tree) % 16)
    return (int)cudaErrorInvalidValue;
  if (np == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 4 << levels;
  cudaError_t err = cudaFuncSetAttribute(search_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  index_kernel<<<dbt::blocks_for(int64_t(1) << levels, INDEX_THREADS), INDEX_THREADS, 0, s>>>(
      static_cast<const uint32_t*>(skey), (int32_t)nb, static_cast<const int32_t*>(bcnt),
      (int32_t)bcnt_host, levels, static_cast<uint32_t*>(tree));
  DBT_CHECK_LAUNCH();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, search_kernel, static_cast<const uint32_t*>(skey), (int32_t)nb,
                           static_cast<const int32_t*>(bcnt), (int32_t)bcnt_host,
                           static_cast<const uint32_t*>(pkey), (int32_t)np,
                           static_cast<const int32_t*>(pcnt), (int32_t)pcnt_host,
                           static_cast<const uint32_t*>(tree), levels, static_cast<bool*>(hit),
                           static_cast<int32_t*>(mult));
  if (err != cudaSuccess) return (int)err;
  DBT_CHECK_LAUNCH();
  return 0;
}
