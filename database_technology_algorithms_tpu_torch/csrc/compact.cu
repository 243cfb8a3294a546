// K3: stable compaction.
//
// Replaces the JAX package's compact_words (ops/movement.py:479), a 2-key
// lax.sort of (drop, row) carrying the payload words: kept rows first, in
// order, then the dropped rows, in order.
//
// Bound on the H100: bytes.  Per row it reads the 1-byte keep flag and
// 4 bytes per payload word, and writes 4 bytes per payload word.  A sort is
// not needed for a two-valued key, and neither is a scan of every row: the
// rows are cut into the tiles of scan.cuh (SCAN_TILE rows, 16 a thread).
//   1. compact_count reads keep once as 16-byte vectors, COUNT_TILES tiles
//      a block, and counts each tile's kept rows; its last block (an atomic
//      done counter) turns the counts into exclusive tile offsets and the
//      total, on the card.
//   2. compact_move, a block a tile, reads keep again (1 byte a row) and
//      each payload word once, ranks the tile's kept and dropped rows by
//      popcounts and a block scan, stages each word's kept run and dropped
//      run in shared memory, and writes both runs coalesced, to
//      offset + rank and total + tile start - offset + rank.
// Up to eight words move per launch 2; a payload slot without a source is
// the row index plus a base, written without reading an iota.  The count
// stays on the card: the wrapper returns a view of the total.
#include "scan.cuh"

namespace {

using dbt::SCAN_ITEMS;
using dbt::SCAN_THREADS;
using dbt::SCAN_TILE;

// scratch: done counter, the total (kernels/scan_plan.py: COUNT_WORD), and a
// kept-row count, then offset, a tile
inline int64_t compact_scratch_words(int64_t n) { return 2 + dbt::scan_tiles(n); }

struct CompactWords {
  const uint32_t* src[dbt::MAX_WORDS];  // null: the row index plus base[k]
  uint32_t* dst[dbt::MAX_WORDS];
  uint32_t base[dbt::MAX_WORDS];
  int count;
};

constexpr int COUNT_TILES = 4;  // tiles one block of launch 1 counts (tools/scan_sweep.py)

__global__ void __launch_bounds__(SCAN_THREADS)
compact_count(const uint8_t* keep, int64_t n, int64_t tiles, uint32_t* scratch) {
  __shared__ dbt::SegPair s_warp[32];
  __shared__ uint32_t s_cnt[dbt::SCAN_WARPS][COUNT_TILES];
  __shared__ bool s_last;
  uint32_t* done = scratch;
  uint32_t* offs = scratch + 2;
  const int tid = threadIdx.x;
  const int64_t tile0 = (int64_t)blockIdx.x * COUNT_TILES;
  // 16 consecutive rows a thread and tile; every load issued before any is
  // used where the block's tiles are whole and keep is 16-byte aligned
  uint32_t w[COUNT_TILES][4];
  if ((tile0 + COUNT_TILES) * SCAN_TILE <= n && dbt::aligned_to(keep, 16)) {
#pragma unroll
    for (int u = 0; u < COUNT_TILES; ++u) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          keep + (tile0 + u) * SCAN_TILE + (int64_t)tid * SCAN_ITEMS);
      w[u][0] = x.x;
      w[u][1] = x.y;
      w[u][2] = x.z;
      w[u][3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < COUNT_TILES; ++u)
      dbt::load_bytes16(keep, (tile0 + u) * SCAN_TILE + (int64_t)tid * SCAN_ITEMS, n, w[u]);
  }
#pragma unroll
  for (int u = 0; u < COUNT_TILES; ++u) {
    const uint32_t c = __reduce_add_sync(dbt::FULL_MASK, __popc(dbt::byte_mask16(w[u])));
    if ((tid & 31) == 0) s_cnt[tid >> 5][u] = c;
  }
  __syncthreads();
  if (tid < COUNT_TILES && tile0 + tid < tiles) {
    uint32_t c = 0u;
#pragma unroll
    for (int k = 0; k < dbt::SCAN_WARPS; ++k) c += s_cnt[k][tid];
    offs[tile0 + tid] = c;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: exclusive offsets in place, SCAN_TILE tiles a round
  __threadfence();
  uint32_t carry = 0u;
  for (int64_t base = 0; base < tiles; base += SCAN_TILE) {
    const int64_t i0 = base + (int64_t)tid * SCAN_ITEMS;
    uint32_t c[SCAN_ITEMS], sum = 0u;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      c[k] = i0 + k < tiles ? __ldcg(&offs[i0 + k]) : 0u;
      sum += c[k];
    }
    uint32_t round;
    uint32_t run = carry + dbt::block_exclusive_sum(sum, &round, s_warp);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (i0 + k < tiles) offs[i0 + k] = run;
      run += c[k];
    }
    carry += round;
  }
  if (tid == 0) scratch[1] = carry;
}

__global__ void __launch_bounds__(SCAN_THREADS)
compact_move(const uint8_t* keep, int64_t n, const uint32_t* scratch, CompactWords w) {
  __shared__ uint32_t s_rows[2][SCAN_TILE];  // a word's tile in output order, two words
  __shared__ uint32_t s_kept[dbt::SCAN_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * SCAN_TILE;
  const int tile_n = n - tile0 < SCAN_TILE ? (int)(n - tile0) : SCAN_TILE;
  const uint32_t keep_off = scratch[2 + blockIdx.x];
  // the output row of the tile's first dropped row (mod 2^32; < 2^31)
  const uint32_t drop_off = scratch[1] + (uint32_t)tile0 - keep_off;
  // the rows of scan.cuh's warp-striped layout: group k of warp w is 128
  // rows, lane L holding 4; a warp's access of a group is one run
  const int pos0 = warp * 32 * SCAN_ITEMS + lane * 4;  // + 128 k + i: the row in the tile
  const int64_t row0 = tile0 + pos0;  // vector k at row0 + 128 k
  const bool whole = tile_n == SCAN_TILE;
  uint32_t m[dbt::SCAN_GROUPS], before[dbt::SCAN_GROUPS];
  dbt::load_bits(keep, row0, 128, n, whole && dbt::aligned_to(keep, 4), m);  // past n: 0
  uint32_t kept = 0u;  // the warp's kept rows in the groups so far
  const uint32_t lower = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < dbt::SCAN_GROUPS; ++k) {
    uint32_t below = 0u, group = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned b = __ballot_sync(dbt::FULL_MASK, (m[k] >> i) & 1u);
      below += __popc(b & lower);
      group += __popc(b);
    }
    before[k] = kept + below;  // kept rows of the warp before the lane's 4
    kept += group;
  }
  if (lane == 0) s_kept[warp] = kept;
  __syncthreads();
  uint32_t wbefore = 0u, tkept = 0u;  // kept rows of the warps before, of the tile
#pragma unroll
  for (int u = 0; u < dbt::SCAN_WARPS; ++u) {
    const uint32_t c = s_kept[u];
    wbefore += u < warp ? c : 0u;
    tkept += c;
  }
  // each row's place in the staged tile: kept rows by kept rank, then the
  // dropped rows by drop rank
  uint32_t slot[dbt::SCAN_GROUPS][4];
#pragma unroll
  for (int k = 0; k < dbt::SCAN_GROUPS; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t r = wbefore + before[k] + __popc(m[k] & ((1u << i) - 1u));
      slot[k][i] = (m[k] >> i) & 1u ? r : tkept + (uint32_t)(pos0 + k * 128 + i) - r;
    }
  }
  for (int q = 0; q < w.count; ++q) {
    uint32_t* s = s_rows[q & 1];
    uint32_t v[dbt::SCAN_GROUPS][4];
    if (w.src[q]) {
      dbt::load_vectors(w.src[q], row0, 128, n, whole && dbt::aligned_to(w.src[q], 16), 0u, v);
    } else {
#pragma unroll
      for (int k = 0; k < dbt::SCAN_GROUPS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[k][i] = w.base[q] + (uint32_t)(row0 + k * 128 + i);
    }
#pragma unroll
    for (int k = 0; k < dbt::SCAN_GROUPS; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (row0 + k * 128 + i < n) s[slot[k][i]] = v[k][i];
    // also orders the reads of word q - 2, which used this buffer, before
    // the writes above of the next word to use it
    __syncthreads();
    uint32_t* dst = w.dst[q];
    for (int j = tid; j < tile_n; j += SCAN_THREADS)
      dst[j < (int)tkept ? keep_off + (uint32_t)j : drop_off + (uint32_t)(j - (int)tkept)] = s[j];
  }
}

}  // namespace

// keep u8[n]; src/dst: nwords u32[n] columns each (a null src is the row
// index plus bases[k]); scratch: the plan's scratch_words u32, of which word
// 1 holds the count afterwards.  tile_rows and scratch_words are the plan's
// (kernels/scan_plan.py); a plan that differs is refused.  One memset of the
// done counter, launch 1, and one launch 2 for every eight words.
DBT_API int dbt_compact(const void* keep, int64_t n, const void* const* src,
                        const uint32_t* bases, void* const* dst, int nwords, void* scratch,
                        int64_t tile_rows, int64_t scratch_words, void* stream) {
  if (tile_rows != SCAN_TILE || scratch_words != compact_scratch_words(n) ||
      n > dbt::SCAN_MAX_ROWS || nwords < 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* k = static_cast<const uint8_t*>(keep);
  uint32_t* s = static_cast<uint32_t*>(scratch);
  const unsigned tiles = (unsigned)dbt::scan_tiles(n);
  cudaError_t ce = cudaMemsetAsync(s, 0, sizeof(uint32_t), st);
  if (ce != cudaSuccess) return (int)ce;
  compact_count<<<(tiles + COUNT_TILES - 1) / COUNT_TILES, SCAN_THREADS, 0, st>>>(k, n, tiles, s);
  DBT_CHECK_LAUNCH();
  for (int first = 0; first < nwords; first += dbt::MAX_WORDS) {
    CompactWords w;
    w.count = nwords - first < dbt::MAX_WORDS ? nwords - first : dbt::MAX_WORDS;
    for (int i = 0; i < w.count; ++i) {
      w.src[i] = static_cast<const uint32_t*>(src[first + i]);
      w.dst[i] = static_cast<uint32_t*>(dst[first + i]);
      w.base[i] = bases[first + i];
    }
    compact_move<<<tiles, SCAN_THREADS, 0, st>>>(k, n, s, w);
    DBT_CHECK_LAUNCH();
  }
  return 0;
}
