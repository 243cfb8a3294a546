// K11: tile copy through shared memory by bulk asynchronous copies.
//
// Replaces the Pallas probe make_kernel(G, n) of the JAX repository's
// tools/bench_pallas_dma.py:43,73: per tile of `tile` record rows of w u32
// words, one load of the tile into fast memory, then tile/g stores of g-row
// chunks at runtime offsets: chunk j of tile t lands at record row
// starts[t] + j*g.  What the probe measures is the cost of issuing a copy.
//
// Hopper form: one block (one warp) a tile.  Lane 0 loads a stage of the
// tile with cp.async.bulk global -> shared, completing on an mbarrier
// (complete_tx::bytes); the lanes then issue the chunks of that stage as
// cp.async.bulk shared -> global stores, a lane every 32nd chunk, each lane
// committing its bulk group and waiting until its stores have read the
// stage before the next load reuses it.  A TPU tile is 2048 x 32 words =
// 256 KiB, more than a block's 227 KiB of shared memory, so the wrapper
// stages it in parts of at most 128 KiB (two halves for the probe); a chunk
// that spans a stage boundary (g = 2048) is issued as one copy a stage.
// Bulk copies need 16-byte aligned addresses and sizes: a row is 4w bytes
// and chunks and stages are multiples of 32 rows.
//
// Bound on the H100: bytes (each word read once and written once).  One
// 128 KiB stage a block leaves one block an SM, so loads and stores of a
// block do not overlap: a first form, right before fast.
#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(32)
tile_copy_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ starts,
                 uint8_t* __restrict__ out, int tile, int w, int g, int stage_rows) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const int64_t row_bytes = (int64_t)w * 4;
  const uint32_t bar_a = smem_addr(&bar);
  const uint32_t stage_a = smem_addr(stage);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const uint8_t* src = x + (int64_t)blockIdx.x * tile * row_bytes;
  uint8_t* dst = out + (int64_t)starts[blockIdx.x] * row_bytes;
  const uint32_t stage_bytes = (uint32_t)(stage_rows * row_bytes);
  for (int h = 0, lo = 0; lo < tile; ++h, lo += stage_rows) {
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar_a), "r"(stage_bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(stage_a), "l"(reinterpret_cast<uint64_t>(src + lo * row_bytes)),
          "r"(stage_bytes), "r"(bar_a) : "memory");
    }
    uint32_t done = 0;
    while (!done) {  // the load of stage h completes phase h of the barrier
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done) : "r"(bar_a), "r"(h & 1) : "memory");
    }
    // the chunks of this stage (a chunk that spans stages: its part here)
    const int j0 = lo / g, j1 = (lo + stage_rows - 1) / g;
    for (int j = j0 + lane; j <= j1; j += 32) {
      const int a = max(j * g, lo);
      const int b = min((j + 1) * g, lo + stage_rows);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(reinterpret_cast<uint64_t>(dst + a * row_bytes)),
                   "r"(stage_a + (uint32_t)((a - lo) * row_bytes)),
                   "r"((uint32_t)((b - a) * row_bytes)) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the next load reuses the stage: every lane's stores must have read it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    __syncwarp();
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// x u32[n, w] (n = ntiles * tile rows), starts i32[ntiles] on the device,
// out u32[n, w]; the wrapper checks the alignment, the divisibility and that
// the tiles land disjoint inside [0, n).  stage_rows divides tile and
// stage_rows * 4w bytes fit a block's shared memory.
DBT_API int dbt_tile_copy(const void* x, const void* starts, void* out, int64_t ntiles, int tile,
                          int w, int g, int stage_rows, void* stream) {
  if (ntiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = stage_rows * w * 4;
  cudaError_t err = cudaFuncSetAttribute(
      tile_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tile_copy_kernel<<<(unsigned)ntiles, 32, smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(starts),
      static_cast<uint8_t*>(out), tile, w, g, stage_rows);
  DBT_CHECK_LAUNCH();
  return 0;
}
