// K12: tile-relative row gather or row scatter, on the row-move engine of
// rowmove.cuh.
//
// Replaces the Pallas probe make_rowmove(load) of the JAX repository's
// tools/bench_permute_prims.py:155,176 (P5 per-row VMEM load, P4 per-row
// VMEM store), and is the word-placement gather of the placement route
// (ops/movement.py place_words, place_group, place_words_2d): those are the
// same function with one tile spanning all rows.  x is u32 [n, w]; tile t
// covers rows [t*tile, min((t+1)*tile, n)) and slot holds tile-relative rows:
//   load:  out[r] = x[base(r) + slot[r]], a zero row where the slot lies
//          outside r's tile or, with a live count, where r >= count;
//   store: out[base(r) + slot[r]] = x[r] for slots inside the tile, into an
//          output the wrapper zeroed.  Two rows of a tile with the same slot
//          race; the probe's slots are a permutation of each tile.
//
// Bound on the H100: bytes.  Per row it reads the 4-byte slot and w words
// and writes w words.  A TPU tile of 2048 x 36 words (288 KiB) exceeds an
// SM's shared memory, so the move works from device memory; a probe tile
// stays in L2.  A block owns up to 1024 rows of the ordered side (the
// output of a load, the input of a store): one thread a row reads the slot
// and finds the tile base (one 32-bit modulo a row, none a word), and the
// rows move as vectors of up to 16 bytes (rowmove::move_span).  Beyond L2
// the plan gives small spans, so the blocks in flight write near each
// other; the store's scattered 144-byte rows still leave partial sectors.
#include "rowmove.cuh"

namespace {

using namespace dbt::rowmove;

struct MoveArgs {
  const void* x;
  const int32_t* slot;
  void* out;
  int32_t n;
  uint32_t tile;  // in [1, n]
  const int32_t* count;
  int32_t count_host;
  int32_t rows;  // rows a block owns
  Divider dv;    // vectors a row
};

template <int V, bool LOAD>
__global__ void __launch_bounds__(THREADS) row_move_kernel(MoveArgs a) {
  __shared__ int32_t s_part[MAX_ROWS];
  const uint32_t row0 = blockIdx.x * (uint32_t)a.rows;
  const int rows = min(a.rows, a.n - (int)row0);
  const int32_t cnt = LOAD ? live_count(a.count, a.count_host) : a.n;
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const uint32_t pos = row0 + (uint32_t)i;
    const int32_t s = a.slot[pos];
    const uint32_t base = pos - pos % a.tile;
    const uint32_t lim = min(a.tile, (uint32_t)a.n - base);
    s_part[i] = ((int32_t)pos < cnt && s >= 0 && (uint32_t)s < lim) ? (int32_t)(base + s) : -1;
  }
  __syncthreads();
  using T = typename Vec<V>::T;
  move_span<V, LOAD>(static_cast<const T*>(a.x), static_cast<T*>(a.out), s_part, row0,
                     (uint32_t)rows, a.dv);
}

template <bool LOAD>
void launch(int vec, unsigned grid, cudaStream_t st, const MoveArgs& a) {
  if (vec == 4)
    row_move_kernel<4, LOAD><<<grid, THREADS, 0, st>>>(a);
  else if (vec == 2)
    row_move_kernel<2, LOAD><<<grid, THREADS, 0, st>>>(a);
  else
    row_move_kernel<1, LOAD><<<grid, THREADS, 0, st>>>(a);
}

}  // namespace

// x u32[n, w] row-major; slot i32[n]; out u32[n, w] (zeroed by the caller
// for the store form); tile >= 1.  count: a device int32 live count, or
// null for `count_host` (load form only).  vec: the access width in words
// (4, 2 or 1) dividing w and the alignment of x and out; rows: the rows a
// block owns (kernels/rowmove_plan.py).
DBT_API int dbt_row_move(const void* x, const void* slot, void* out, int64_t n, int w,
                         int64_t tile, int load, const void* count, int64_t count_host,
                         int vec, int rows, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  if (tile <= 0 || n > INT32_MAX || rows < 1 || rows > MAX_ROWS ||
      (vec != 1 && vec != 2 && vec != 4) || w % vec != 0 || !split_exact(rows, w / vec) ||
      count_host < INT32_MIN || count_host > INT32_MAX || (!load && count))
    return (int)cudaErrorInvalidValue;
  if (misaligned(x, vec) || misaligned(out, vec)) return (int)cudaErrorMisalignedAddress;
  MoveArgs a;
  a.x = x;
  a.slot = static_cast<const int32_t*>(slot);
  a.out = out;
  a.n = (int32_t)n;
  a.tile = (uint32_t)(tile < n ? tile : n);  // a tile past the rows is one tile
  a.count = static_cast<const int32_t*>(count);
  a.count_host = (int32_t)count_host;
  a.rows = rows;
  a.dv = divider((uint32_t)(w / vec));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = dbt::blocks_for(n, rows);
  if (load)
    launch<true>(vec, grid, st, a);
  else
    launch<false>(vec, grid, st, a);
  DBT_CHECK_LAUNCH();
  return 0;
}
