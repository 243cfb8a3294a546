// K9: rows staged into padded [nparts, cap] cells by destination, and the
// counting primitive value_boundaries.
//
// Replaces the JAX package's stage_to_cells (ops/movement.py:354-461) and
// value_boundaries (ops/movement.py:319-351).  The JAX form is two rank
// sorts plus placeholder-pinned placement sorts, because a TPU scatters
// badly.  On the card it is a stable partition:
//   bucket   d = active ? dest : nparts, clamped to nparts (one sink bucket
//            for inactive rows and destinations out of range), with a
//            histogram of the buckets (warp-aggregated atomics, so that a
//            table whose keys are all equal does not serialize);
//   scan     of the nparts + 1 bucket counts (scan.cuh, K2's scan);
//   order    a stable LSD radix sort of the row index by bucket, the
//            one-sweep sort of radix.cuh with one 8-bit pass for every 8 bits
//            of nparts (2 passes for 4096 cells): the staging permutation si,
//            rows in (bucket, row) order;
//   place    sorted position i of bucket b has rank i - start[b]; the row
//            goes to slot b * cap + rank where rank < cap, its payload words
//            are gathered there, and its slot is written to the row map;
//   fill     slots past each cell's count are zeroed.
// "Stable" means that rank within a destination follows the row index,
// which is what JAX's (d, iota) sort gives; counts are clamped to cap and
// the rows beyond cap are counted as overflow and not staged.
//
// Bound on the H100: bytes.  Per row it reads dest (4 B), active (1 B) and
// w payload words and writes the w words, plus the nparts * cap cell slots
// that stay zero.  The radix passes move 8 B a row each beyond that.
#include "radix.cuh"
#include "scan.cuh"

namespace {

constexpr int ST_THREADS = 256;

struct CellPtrs {
  uint32_t* ptr[dbt::MAX_KEY_WORDS];
  int count;
};

__global__ void stage_zero(uint32_t* hist, int64_t nbins, uint32_t* stats) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nbins) hist[i] = 0u;
  if (stats && i < 3) stats[i] = 0u;
}

// keys_out[i] = min(active[i] ? dest[i] : nparts, nparts); hist counts the
// buckets; stats[1] counts the active rows whose destination is above nparts.
// active, keys_out and stats may be null.
__global__ void __launch_bounds__(ST_THREADS)
stage_bucket(const uint32_t* dest, const uint8_t* active, int64_t n, uint32_t nparts,
             uint32_t* keys_out, uint32_t* hist, uint32_t* stats) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < n;
  uint32_t b = nparts;
  bool beyond = false;
  if (live) {
    const uint32_t d = (!active || active[i]) ? dest[i] : nparts;
    beyond = d > nparts;
    b = beyond ? nparts : d;
    if (keys_out) keys_out[i] = b;
  }
  const unsigned live_mask = __ballot_sync(dbt::FULL_MASK, live);
  if (live) {
    const unsigned peers = __match_any_sync(live_mask, b);
    if (lane == __ffs(peers) - 1) atomicAdd(&hist[b], (uint32_t)__popc(peers));
  }
  const unsigned beyond_mask = __ballot_sync(dbt::FULL_MASK, beyond);
  if (stats && beyond_mask && lane == 0) atomicAdd(&stats[1], (uint32_t)__popc(beyond_mask));
}

// counts[c] = min(hist[c], cap); stats[0] += the rows beyond cap; stats[2] =
// the size of the sink bucket.
__global__ void stage_counts(const uint32_t* hist, int64_t nparts, uint32_t cap, uint32_t* counts,
                             uint32_t* stats) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nparts) return;
  if (c == 0) stats[2] = hist[nparts];
  const uint32_t h = hist[c];
  counts[c] = h < cap ? h : cap;
  if (h > cap) atomicAdd(&stats[0], h - cap);
}

// out[p] = number of elements below p = the exclusive prefix of the counts
__global__ void boundaries_out(const uint32_t* hist, const uint32_t* incl, int64_t nprobes,
                               uint32_t* out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < nprobes) out[p] = incl[p] - hist[p];
}

__global__ void __launch_bounds__(ST_THREADS)
stage_place(const uint32_t* sorted_b, const int32_t* si, const uint32_t* hist,
            const uint32_t* incl, int64_t n, uint32_t nparts, uint32_t cap, dbt::KeyCols pay,
            CellPtrs cells, int32_t* slot_of_row) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t b = sorted_b[i];
  const int64_t row = si[i];
  const int64_t m = (int64_t)nparts * cap;
  int64_t slot = m;
  if (b < nparts) {
    const int64_t rank = i - (int64_t)(incl[b] - hist[b]);
    if (rank < (int64_t)cap) slot = (int64_t)b * cap + rank;
  }
  if (slot < m) {
    for (int k = 0; k < cells.count; ++k) cells.ptr[k][slot] = pay.ptr[k][row * pay.stride[k]];
  }
  if (slot_of_row) slot_of_row[row] = (int32_t)slot;
}

__global__ void __launch_bounds__(ST_THREADS)
stage_fill_dead(const uint32_t* hist, int64_t nparts, int64_t cap, CellPtrs cells) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= nparts * cap) return;
  const int64_t c = j / cap;
  if (j - c * cap >= (int64_t)hist[c]) {
    for (int k = 0; k < cells.count; ++k) cells.ptr[k][j] = 0u;
  }
}

int bucket_passes(int64_t nparts) {
  int p = 1;
  while (p < 4 && (nparts >> (8 * p)) != 0) ++p;
  return p;
}

}  // namespace

DBT_API int64_t dbt_value_boundaries_scratch_words(int64_t nprobes) {
  const int64_t nbins = nprobes + 1;
  return 2 * nbins + dbt::seg_scan_scratch_words(nbins);
}

// out[p] = number of d[i] (as u32) below p, for p in [0, nprobes).
DBT_API int dbt_value_boundaries(const void* d, int64_t n, int64_t nprobes, void* out,
                                 void* scratch, void* stream) {
  if (nprobes <= 0) return 0;
  if (nprobes >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nbins = nprobes + 1;
  uint32_t* hist = static_cast<uint32_t*>(scratch);
  uint32_t* incl = hist + nbins;
  uint32_t* scan = incl + nbins;
  stage_zero<<<dbt::blocks_for(nbins, ST_THREADS), ST_THREADS, 0, st>>>(hist, nbins, nullptr);
  DBT_CHECK_LAUNCH();
  if (n > 0) {
    stage_bucket<<<dbt::blocks_for(n, ST_THREADS), ST_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(d), nullptr, n, (uint32_t)nprobes, nullptr, hist, nullptr);
    DBT_CHECK_LAUNCH();
  }
  int err = dbt::seg_scan_launch<dbt::SumOp>(nullptr, hist, 4, incl, scan, nbins, false, st);
  if (err) return err;
  boundaries_out<<<dbt::blocks_for(nprobes, ST_THREADS), ST_THREADS, 0, st>>>(
      hist, incl, nprobes, static_cast<uint32_t*>(out));
  DBT_CHECK_LAUNCH();
  return 0;
}

DBT_API int64_t dbt_stage_cells_scratch_words(int64_t n, int64_t nparts) {
  const int64_t nbins = nparts + 1;
  return 2 * n + 2 * nbins + dbt::seg_scan_scratch_words(nbins) +
         dbt::radix_scratch_words(n, bucket_passes(nparts));
}

// dest u32[n]; active u8[n] or null (every row active); pay_in: npay device
// pointers (host array) to u32 columns of n rows with their row strides;
// cells: npay device pointers to u32[nparts * cap]; counts u32[nparts];
// stats u32[3] = (overflow, active rows with dest > nparts, rows of the sink
// bucket); si i32[n], the rows in (bucket, row) order; slot_of_row i32[n] or
// null.
DBT_API int dbt_stage_cells(const void* dest, const void* active, int64_t n, int64_t nparts,
                            int64_t cap, const void* const* pay_in, const int64_t* pay_strides,
                            void* const* cells, int npay, void* counts, void* stats, void* si,
                            void* slot_of_row, void* scratch, void* stream) {
  if (nparts < 1 || cap < 1 || npay < 0 || npay > dbt::MAX_KEY_WORDS)
    return (int)cudaErrorInvalidValue;
  if (nparts >= ((int64_t)1 << 31) || cap >= ((int64_t)1 << 31) ||
      nparts * cap >= ((int64_t)1 << 31) || n > dbt::RS_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nbins = nparts + 1;
  // the rows' buckets, then the same in (bucket, row) order
  uint32_t* kbuf[2] = {static_cast<uint32_t*>(scratch), static_cast<uint32_t*>(scratch) + n};
  uint32_t* hist = kbuf[1] + n;
  uint32_t* incl = hist + nbins;
  uint32_t* scan = incl + nbins;
  uint32_t* radix_base = scan + dbt::seg_scan_scratch_words(nbins);
  uint32_t* st_stats = static_cast<uint32_t*>(stats);
  CellPtrs cp;
  cp.count = npay;
  for (int k = 0; k < npay; ++k) cp.ptr[k] = static_cast<uint32_t*>(cells[k]);

  stage_zero<<<dbt::blocks_for(nbins + 2, ST_THREADS), ST_THREADS, 0, st>>>(hist, nbins, st_stats);
  DBT_CHECK_LAUNCH();
  if (n > 0) {
    stage_bucket<<<dbt::blocks_for(n, ST_THREADS), ST_THREADS, 0, st>>>(
        static_cast<const uint32_t*>(dest), static_cast<const uint8_t*>(active), n,
        (uint32_t)nparts, kbuf[0], hist, st_stats);
    DBT_CHECK_LAUNCH();
  }
  int err = dbt::seg_scan_launch<dbt::SumOp>(nullptr, hist, 4, incl, scan, nbins, false, st);
  if (err) return err;
  stage_counts<<<dbt::blocks_for(nparts, ST_THREADS), ST_THREADS, 0, st>>>(
      hist, nparts, (uint32_t)cap, static_cast<uint32_t*>(counts), st_stats);
  DBT_CHECK_LAUNCH();
  if (n > 0) {
    const int passes = bucket_passes(nparts);
    int32_t sched[3 * 4];
    for (int t = 0; t < passes; ++t) {
      sched[3 * t] = 0;
      sched[3 * t + 1] = 8 * t;
      sched[3 * t + 2] = 0;
    }
    const void* words[1] = {kbuf[0]};
    const int64_t strides[1] = {1};
    dbt::RadixIO io;
    io.cols = dbt::key_cols(words, strides, 1);
    io.inact = nullptr;
    io.keys_out = kbuf[1];
    io.perm_out = static_cast<int32_t*>(si);
    io.act_out = nullptr;
    err = dbt::radix_sort(io, sched, passes, n, radix_base, st);
    if (err) return err;
    stage_place<<<dbt::blocks_for(n, ST_THREADS), ST_THREADS, 0, st>>>(
        kbuf[1], static_cast<const int32_t*>(si), hist, incl, n, (uint32_t)nparts,
        (uint32_t)cap, dbt::key_cols(pay_in, pay_strides, npay), cp,
        static_cast<int32_t*>(slot_of_row));
    DBT_CHECK_LAUNCH();
  }
  if (npay > 0) {
    stage_fill_dead<<<dbt::blocks_for(nparts * cap, ST_THREADS), ST_THREADS, 0, st>>>(
        hist, nparts, cap, cp);
    DBT_CHECK_LAUNCH();
  }
  return 0;
}
