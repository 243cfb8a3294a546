// K12: tile-relative row gather or row scatter.
//
// Replaces the Pallas probe make_rowmove(load) of the JAX repository's
// tools/bench_permute_prims.py:155,176 (P5 per-row VMEM load, P4 per-row
// VMEM store), and is the word-placement gather of the placement route
// (ops/movement.py place_words, place_group, place_words_2d): those are the
// same function with one tile spanning all rows.  x is u32 [n, w]; tile t
// covers rows [t*tile, min((t+1)*tile, n)) and slot holds tile-relative rows:
//   load:  out[r] = x[base(r) + slot[r]], a zero row where the slot lies
//          outside r's tile;
//   store: out[base(r) + slot[r]] = x[r] for slots inside the tile, into an
//          output the wrapper zeroed.  Two rows of a tile with the same slot
//          race; the probe's slots are a permutation of each tile.
//
// Bound on the H100: bytes.  Per row it reads the 4-byte slot and w words
// and writes w words.  A TPU tile of 2048 x 36 words (288 KiB) exceeds an
// SM's shared memory, so this first form works from device memory, one
// thread per (row, word) with a row's words on neighbouring threads: reads
// (load) or writes (store) of a row are coalesced, the other side is one
// random row per w threads.  A probe tile of 2048 rows stays in L2.
#include "common.cuh"

namespace {

__global__ void row_move_kernel(const uint32_t* __restrict__ x, const int32_t* __restrict__ slot,
                                uint32_t* __restrict__ out, int64_t n, int w, int64_t tile,
                                int load) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * w) return;
  const int64_t row = e / w;
  const int col = (int)(e - row * w);
  const int64_t base = row - row % tile;
  const int64_t end = min(base + tile, n);
  const int64_t s = (int64_t)slot[row];
  const int64_t other = base + s;
  const bool in = s >= 0 && other < end;
  if (load) {
    out[e] = in ? x[other * w + col] : 0u;
  } else if (in) {
    out[other * w + col] = x[e];
  }
}

}  // namespace

// x u32[n, w] row-major; slot i32[n]; out u32[n, w] (zeroed by the caller
// for the store form); tile >= 1.
DBT_API int dbt_row_move(const void* x, const void* slot, void* out, int64_t n, int w,
                         int64_t tile, int load, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (tile <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  row_move_kernel<<<dbt::blocks_for(n * w, 256), 256, 0, st>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(slot),
      static_cast<uint32_t*>(out), n, w, tile, load);
  DBT_CHECK_LAUNCH();
  return 0;
}
