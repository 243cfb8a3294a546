// K11: tile copy through shared memory by bulk asynchronous copies.
//
// Replaces the Pallas probe make_kernel(G, n) of the JAX repository's
// tools/bench_pallas_dma.py:43,73: per tile of `tile` record rows of w u32
// words, one load of the tile into fast memory, then tile/g stores of g-row
// chunks at runtime offsets: chunk j of tile t lands at record row
// starts[t] + j*g.  What the probe measures is the cost of issuing a copy.
//
// Bound on the H100: bytes (each word read once and written once).  The
// copies are cp.async.bulk (the TMA's one-dimensional form): global ->
// shared completing on an mbarrier (complete_tx::bytes), shared -> global
// completing as bulk groups.  To keep the card's memory busy, loads and
// stores have to be in flight together on every SM, all the time:
// - the rows are cut into units of unit_rows rows (a multiple of 32, dividing
//   the tile, so a unit lies in one tile);
// - the grid is persistent: blocks_per_sm blocks an SM, all resident at
//   once.  A block takes its next unit from a counter that every block of
//   the launch shares (one atomicAdd a unit), so no SM idles while another
//   still has a long range to go.  The counter is the caller's: 16 bytes
//   that the wrapper allocates for the call and the entry zeroes on the
//   call's stream before the launch, so launches on other streams, or after
//   one that failed midway, share nothing;
// - each block keeps a ring of `ring` unit buffers in shared memory with one
//   "full" mbarrier each.  Its one thread loads the first `ring` units it
//   takes, then for the k-th: waits for its barrier, issues its chunk stores
//   (a chunk part a store: chunk j of the tile clipped to the unit) as one
//   bulk group, and reloads the buffer of the (k-1)-th with the next unit
//   once cp.async.bulk.wait_group.read 1 says the (k-1)-th unit's stores
//   have read it.  So the stores of up to two units and the loads of
//   ring - 1 are in flight in each block;
// - the thread reads starts[t] when it loads a unit of tile t, unless the
//   unit before it in that block lay in the same tile.
// Bulk copies need 16-byte aligned addresses and sizes: a row is 4w bytes,
// and units, chunks and starts are multiples of 32 rows.  The plan comes
// from kernels/tile_copy.py copy_plan; the entry below repeats its refusals.
#include "common.cuh"

namespace {

constexpr int MAX_RING = 16;           // kernels/tile_copy.py MAX_RING
constexpr int RING_BYTES = 232448 - 1024;  // kernels/tile_copy.py RING_BYTES
constexpr int COUNTER_BYTES = 16;          // kernels/tile_copy.py COUNTER_BYTES

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void load_unit(uint32_t buf, uint32_t bar, const uint8_t* src,
                                          uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(buf), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void wait_full(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// the next unit of the launch: the units taken so far (one past the end a
// block, at its last take)
__device__ __forceinline__ int64_t take_unit(unsigned long long* next_unit) {
  return (int64_t)atomicAdd(next_unit, 1ull);
}

__global__ void __launch_bounds__(1)
tile_copy_kernel(const uint8_t* __restrict__ x, const int32_t* __restrict__ starts,
                 uint8_t* __restrict__ out, int64_t units, int tile, int w, int g, int unit_rows,
                 int ring, unsigned long long* __restrict__ next_unit) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) uint64_t full[MAX_RING];
  __shared__ int64_t held[MAX_RING];  // the unit in each buffer
  __shared__ int64_t dst[MAX_RING];   // byte offset of its tile's destination
  const int64_t row_bytes = (int64_t)w * 4;
  const uint32_t unit_bytes = (uint32_t)(unit_rows * row_bytes);
  const int64_t per_tile = tile / unit_rows;
  const uint32_t buf_a = smem_addr(buf), full_a = smem_addr(full);
  for (int b = 0; b < ring; ++b)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(full_a + 8 * b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  int64_t t_read = -1;  // the tile whose start this block read last
  int64_t dst_read = 0;
  int64_t loaded = 0;  // the units this block loaded
  auto load = [&](int64_t u) {
    const int b = (int)(loaded % ring);
    const int64_t t = u / per_tile;
    if (t != t_read) {
      t_read = t;
      dst_read = (int64_t)starts[t] * row_bytes;
    }
    held[b] = u;
    dst[b] = dst_read;
    load_unit(buf_a + (uint32_t)b * unit_bytes, full_a + 8 * (uint32_t)b,
              x + u * unit_rows * row_bytes, unit_bytes);
    ++loaded;
  };
  int64_t next = take_unit(next_unit);  // the unit this block loads next, if < units
  for (; loaded < ring && next < units; next = take_unit(next_unit)) load(next);
  for (int64_t k = 0; k < loaded; ++k) {
    const int b = (int)(k % ring);
    wait_full(full_a + 8 * b, (uint32_t)((k / ring) & 1));
    const int64_t u = held[b];
    const int lo = (int)(u % per_tile) * unit_rows;  // the unit's first row in its tile
    const uint32_t ub = buf_a + (uint32_t)b * unit_bytes;
    for (int j = lo / g, last = (lo + unit_rows - 1) / g; j <= last; ++j) {
      const int a = max(j * g, lo);
      const int e = min((j + 1) * g, lo + unit_rows);
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   ::"l"(reinterpret_cast<uint64_t>(out + dst[b] + a * row_bytes)),
                   "r"(ub + (uint32_t)((a - lo) * row_bytes)),
                   "r"((uint32_t)((e - a) * row_bytes)) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (k >= 1 && next < units) {  // the buffer of unit k - 1 takes the next unit
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(next);
      next = take_unit(next_unit);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

// x u32[n, w] (n = ntiles * tile rows), starts i32[ntiles] on the device,
// out u32[n, w]; the wrapper checks the divisibility and that the tiles land
// disjoint inside [0, n).  The plan: unit_rows a unit, `ring` buffers a
// block, `blocks` blocks (all resident: kernels/tile_copy.py copy_grid).
// counter: COUNTER_BYTES on the device, 8-byte aligned, zeroed here on the
// stream before the launch.
DBT_API int dbt_tile_copy(const void* x, const void* starts, void* out, int64_t ntiles, int tile,
                          int w, int g, int unit_rows, int ring, int64_t blocks, void* counter,
                          void* stream) {
  if (ntiles <= 0) return 0;
  const int64_t unit_bytes = (int64_t)unit_rows * w * 4;
  if (w < 1 || tile < 1 || g < 32 || g % 32 || tile % g || unit_rows < 32 || unit_rows % 32 ||
      tile % unit_rows || ring < 2 || ring > MAX_RING || ring * unit_bytes > RING_BYTES ||
      blocks < 1 || blocks > INT32_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(counter) % 8)
    return (int)cudaErrorInvalidValue;
  const int64_t units = ntiles * (tile / unit_rows);
  if (blocks > units) blocks = units;
  const int smem = (int)(ring * unit_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      tile_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, COUNTER_BYTES, st);
  if (err != cudaSuccess) return (int)err;
  tile_copy_kernel<<<(unsigned)blocks, 1, smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const int32_t*>(starts),
      static_cast<uint8_t*>(out), units, tile, w, g, unit_rows, ring,
      static_cast<unsigned long long*>(counter));
  DBT_CHECK_LAUNCH();
  return 0;
}
