// K9: rows staged into padded [nparts, cap] cells by destination, and the
// counting primitive value_boundaries.
//
// Replaces the JAX package's stage_to_cells (ops/movement.py:354-461) and
// value_boundaries (ops/movement.py:319-351).  The JAX form is two rank
// sorts plus placeholder-pinned placement sorts, because a TPU scatters
// badly.  On the card it is a stable partition into nparts + 1 buckets
// (bucket d for an active row with d < nparts; the sink nparts for inactive
// rows, rows at or past the live count and destinations at or above nparts)
// in three passes over the rows and no sort (kernels/cells_plan.py):
//   count   a block owns a span of rows and histograms their buckets in
//           shared memory, warp-aggregated (__match_any_sync), so a span
//           whose rows share a bucket costs one atomic a warp step; it writes
//           its column of the bucket-major matrix [nbins, nspans].  Rows
//           past the live count join the sink unread.
//   scan    K2's engine (scan.cuh) scans the matrix in place: entry (b, s)
//           becomes the place after the last row of (b, s) in (bucket, row)
//           order;
//   finish  each bucket's start, the counts clamped to cap, the overflow and
//           the sink's size, on the card;
//   fill    the caller's fill value (0 unless given; the overlapped
//           join's key-only pack asks for 0xFFFFFFFF) goes into every dead
//           slot, [counts[c], cap) of each cell, a block a chunk of 2048
//           slots of one cell;
//   place   a block owns its span again, each warp a contiguous sub-span:
//           the warps count their sub-spans' buckets into 16-bit counters of
//           their own, the block turns those into each warp's first place a
//           bucket, and each warp walks its sub-span 32 rows a step, a row's
//           place being its warp's counter plus its rank among the step's
//           earlier lanes of its bucket.  Place p of bucket b has rank
//           p - start[b]; the row's payload words, read in row order, go to
//           slot b * cap + rank where rank < cap.
// "Stable" means that rank within a destination follows the row index,
// which is what JAX's (d, iota) sort gives; counts are clamped to cap and
// the rows beyond cap are counted as overflow and not staged.
//
// Bound on the H100: bytes.  Per live row it reads dest (4 B), active (1 B
// where given) and w payload words and writes the w words and its row map
// word, plus the nparts * cap - staged cell slots that take the fill.  The
// passes read dest three times and move the count matrix (4 B a bucket and
// span) through the scan.
#include "scan.cuh"

namespace {

constexpr int ST_COUNT_THREADS = 512;
constexpr int ST_MAX_WARPS = 8;
constexpr int ST_FILL_THREADS = 256;
constexpr int64_t ST_FILL_CHUNK = ST_FILL_THREADS * 8;  // slots of a cell a fill block owns
constexpr int64_t ST_MAX_SPAN = 65535;  // a warp's 16-bit counters
constexpr int ST_UNROLL = 4;            // rows a lane loads before it uses any
constexpr uint32_t ST_OWN = 2048;       // bytes a place warp marks its single lanes in

struct CellPtrs {
  uint32_t* ptr[dbt::MAX_KEY_WORDS];
  int count;
};

struct Rows {
  const uint32_t* dest;
  const uint8_t* active;  // null: every row
  const int32_t* count;   // null: every row is live
  int64_t n;
  uint32_t nparts;        // the sink bucket
  int64_t span;
  int64_t nspans;
  uint32_t* mat;          // [nparts + 1, nspans]
};

// rows [0, live) are read; the rest go to the sink
__device__ __forceinline__ int64_t live_rows(const Rows& r) {
  if (!r.count) return r.n;
  const int64_t c = *r.count;
  return c < 0 ? 0 : (c > r.n ? r.n : c);
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The buckets of rows i0 + u * stride (u < ST_UNROLL) below lim; each
// row's loads are issued before any is used.  `beyond` counts the active
// rows whose destination is above nparts.
__device__ __forceinline__ void load_buckets(const Rows& r, int64_t i0, int64_t stride, int64_t lim,
                                             uint32_t b[ST_UNROLL], uint32_t* beyond) {
  uint32_t d[ST_UNROLL];
  uint8_t act[ST_UNROLL];
#pragma unroll
  for (int u = 0; u < ST_UNROLL; ++u) {
    const int64_t i = i0 + u * stride;
    d[u] = i < lim ? __ldcs(&r.dest[i]) : r.nparts;
    act[u] = (i < lim && r.active) ? r.active[i] : (uint8_t)1;
  }
#pragma unroll
  for (int u = 0; u < ST_UNROLL; ++u) {
    const uint32_t x = act[u] ? d[u] : r.nparts;
    *beyond += x > r.nparts;
    b[u] = x < r.nparts ? x : r.nparts;
  }
}

// A warp step's rows grouped cheaply: the lanes whose bucket is the first
// live lane's (g0, led by that lane) and the lanes of the sink (gs) are found
// by two ballots, so a step whose rows share a bucket, or mostly go to the
// sink, costs one counter update a group; every other live lane is "single".
struct StepGroups {
  unsigned live, g0, gs;
  uint32_t b0;
  int lead;
};

__device__ __forceinline__ StepGroups step_groups(bool in, uint32_t b, uint32_t sink) {
  StepGroups g;
  g.live = __ballot_sync(dbt::FULL_MASK, in);
  g.lead = g.live ? __ffs(g.live) - 1 : 0;
  g.b0 = __shfl_sync(dbt::FULL_MASK, b, g.lead);
  g.g0 = __ballot_sync(dbt::FULL_MASK, in && b == g.b0);
  g.gs = __ballot_sync(dbt::FULL_MASK, in && b == sink && g.b0 != sink);
  return g;
}

// cnt[b] += v on a 16-bit counter, as a 32-bit atomic on its pair (a
// counter never passes 65535, so nothing carries into its neighbour)
__device__ __forceinline__ void add16(uint16_t* cnt, uint32_t b, uint32_t v) {
  atomicAdd(reinterpret_cast<uint32_t*>(cnt) + (b >> 1), v << (16u * (b & 1u)));
}

#ifndef ST_KEEP_WRITES
#define ST_KEEP_WRITES 1
#endif

// The scattered stores of the place pass (si, cells) ask L2 to keep their
// lines (evict_last) while the streamed reads ask to go first (__ldcs), so
// that a sector written a word at a time is whole before it is evicted.
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t p = 0;
#if ST_KEEP_WRITES
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
#endif
  return p;
}

__device__ __forceinline__ void st_keep(void* addr, uint32_t v, uint64_t policy) {
#if ST_KEEP_WRITES
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(addr), "r"(v), "l"(policy)
               : "memory");
#else
  *static_cast<uint32_t*>(addr) = v;
#endif
}

__global__ void __launch_bounds__(ST_COUNT_THREADS)
cells_count(Rows r, uint32_t* stats) {
  extern __shared__ uint32_t s_hist[];
  const int64_t s0 = (int64_t)blockIdx.x * r.span;
  const int64_t s1 = s0 + r.span < r.n ? s0 + r.span : r.n;
  const int64_t lim = clamp64(live_rows(r), s0, s1);
  if (lim == s0) return;  // past the live count: the zeroed column stands
  const uint32_t nbins = r.nparts + 1u;
  const int lane = threadIdx.x & 31;
  for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) s_hist[b] = 0u;
  __syncthreads();
  uint32_t beyond = 0u;
  const int64_t step = (int64_t)blockDim.x * ST_UNROLL;
  for (int64_t base = s0; base < lim; base += step) {  // the same trips in every warp
    uint32_t b[ST_UNROLL];
    load_buckets(r, base + threadIdx.x, blockDim.x, lim, b, &beyond);
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const bool in = base + threadIdx.x + u * (int64_t)blockDim.x < lim;
      const StepGroups g = step_groups(in, b[u], r.nparts);
      if (g.live && lane == g.lead) atomicAdd(&s_hist[g.b0], (uint32_t)__popc(g.g0));
      if (g.gs && lane == __ffs(g.gs) - 1) atomicAdd(&s_hist[r.nparts], (uint32_t)__popc(g.gs));
      if (in && b[u] != g.b0 && b[u] != r.nparts) atomicAdd(&s_hist[b[u]], 1u);
    }
  }
  if (stats) {
    beyond = __reduce_add_sync(dbt::FULL_MASK, beyond);
    if (lane == 0 && beyond) atomicAdd(&stats[1], beyond);
  }
  __syncthreads();
  for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) {
    const uint32_t h = s_hist[b];
    if (h) r.mat[(int64_t)b * r.nspans + blockIdx.x] = h;
  }
}

// From the scanned matrix: starts[b] (b < nstarts), counts[c] = min(total,
// cap) for c < nparts (counts may be null), stats[0] += the rows beyond cap
// and stats[2] = the sink's rows, those past the live count included (stats
// may be null).
__global__ void cells_finish(Rows r, int64_t nstarts, uint32_t cap, uint32_t* starts,
                             uint32_t* counts, uint32_t* stats) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t over = 0u;
  if (b <= (int64_t)r.nparts) {
    const uint32_t start = b == 0 ? 0u : r.mat[b * r.nspans - 1];
    const uint32_t total = r.mat[(b + 1) * r.nspans - 1] - start;
    if (b < nstarts) starts[b] = start;
    if (b < (int64_t)r.nparts) {
      if (counts) counts[b] = total < cap ? total : cap;
      over = total > cap ? total - cap : 0u;
    } else if (stats) {
      stats[2] = total + (uint32_t)(r.n - live_rows(r));
    }
  }
  if (stats) {
    over = __reduce_add_sync(dbt::FULL_MASK, over);
    if ((threadIdx.x & 31) == 0 && over) atomicAdd(&stats[0], over);
  }
}

// The dead slots [counts[c], cap) of every cell become `fill` in every
// payload word: block (x, c) owns slots [x * ST_FILL_CHUNK, +ST_FILL_CHUNK)
// of cell c and writes the dead ones among them, coalesced.  A shuffle's
// few cells of millions of slots spread over the card as evenly as the
// tiled join's thousands of small ones.
__global__ void __launch_bounds__(ST_FILL_THREADS)
cells_fill_dead(const uint32_t* counts, int64_t cap, CellPtrs cells, uint32_t fill) {
  const int64_t c = blockIdx.y;
  const int64_t lo = (int64_t)blockIdx.x * ST_FILL_CHUNK;
  const int64_t hi = lo + ST_FILL_CHUNK < cap ? lo + ST_FILL_CHUNK : cap;
  const int64_t dead = __ldg(&counts[c]);
  for (int64_t j = (lo > dead ? lo : dead) + threadIdx.x; j < hi; j += blockDim.x)
    for (int k = 0; k < cells.count; ++k) __stcs(&cells.ptr[k][c * cap + j], fill);
}

struct PlaceArgs {
  Rows r;
  const uint32_t* starts;  // [nparts + 1]
  uint32_t cap;
  dbt::KeyCols pay;
  CellPtrs cells;
  int32_t* si;           // or null
  int32_t* slot_of_row;  // or null
};

__global__ void __launch_bounds__(32 * ST_MAX_WARPS)
cells_place(PlaceArgs a) {
  extern __shared__ uint32_t s_mem[];
  const Rows& r = a.r;
  const uint32_t nbins = r.nparts + 1u;
  const uint32_t pad = nbins + (nbins & 1u);
  const uint32_t sink = r.nparts;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t* s_base = s_mem;                                      // each bucket's first place
  uint16_t* s_cnt = reinterpret_cast<uint16_t*>(s_mem + nbins);  // [warps][pad]
  uint8_t* s_own = reinterpret_cast<uint8_t*>(s_cnt + (int64_t)warps * pad) + warp * ST_OWN;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int64_t span = blockIdx.x;
  const int64_t s0 = span * r.span;
  const int64_t s1 = s0 + r.span < r.n ? s0 + r.span : r.n;
  const int64_t lim = clamp64(live_rows(r), s0, s1);
  const uint32_t m = r.nparts * a.cap;
  const uint64_t keep = keep_policy();

  // Rows past the live count are the sink's last rows, in row order: row i
  // is at place i, and in no cell.
  if (a.si || a.slot_of_row) {
    for (int64_t i = lim + threadIdx.x; i < s1; i += blockDim.x) {
      if (a.si) __stcs(&a.si[i], (int32_t)i);
      if (a.slot_of_row) __stcs(&a.slot_of_row[i], (int32_t)m);
    }
  }
  if (lim == s0) return;

  uint32_t* zero = reinterpret_cast<uint32_t*>(s_cnt);
  for (uint32_t j = threadIdx.x; j < (uint32_t)warps * pad / 2u; j += blockDim.x) zero[j] = 0u;
  __syncthreads();
  const int64_t sub = r.span / warps;
  const int64_t w0 = s0 + warp * sub < lim ? s0 + warp * sub : lim;
  const int64_t w1 = w0 + sub < lim ? w0 + sub : lim;  // the warp reads rows [w0, w1)
  uint16_t* cnt = s_cnt + (int64_t)warp * pad;
  uint32_t unused = 0u;

  // the warp's bucket counts
  for (int64_t base = w0; base < w1; base += 32 * ST_UNROLL) {
    uint32_t b[ST_UNROLL];
    load_buckets(r, base + lane, 32, w1, b, &unused);
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const bool in = base + lane + 32 * u < w1;
      const StepGroups g = step_groups(in, b[u], sink);
      if (g.live && lane == g.lead) add16(cnt, g.b0, (uint32_t)__popc(g.g0));
      if (g.gs && lane == __ffs(g.gs) - 1) add16(cnt, sink, (uint32_t)__popc(g.gs));
      if (in && b[u] != g.b0 && b[u] != sink) add16(cnt, b[u], 1u);
    }
  }
  __syncthreads();

  // each warp's counters become its first place in the bucket, relative to
  // the span's, which is the scanned entry less the span's rows of the bucket
  for (uint32_t b = threadIdx.x; b < nbins; b += blockDim.x) {
    uint32_t acc = 0u;
    for (int v = 0; v < warps; ++v) {
      const uint32_t h = s_cnt[(int64_t)v * pad + b];
      s_cnt[(int64_t)v * pad + b] = (uint16_t)acc;
      acc += h;
    }
    s_base[b] = acc ? r.mat[(int64_t)b * r.nspans + span] - acc : 0u;
  }
  __syncthreads();

  // the walk: a row's place is its warp's counter plus its rank among the
  // step's earlier lanes of its bucket.  A single lane is its bucket's only
  // row in the step unless another single lane claimed the same byte of
  // s_own; then (and only then) the step's groups come from __match_any_sync.
  const bool pay0 = a.cells.count > 0;
  for (int64_t base = w0; base < w1; base += 32 * ST_UNROLL) {
    uint32_t b[ST_UNROLL], p0[ST_UNROLL];
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const int64_t i = base + lane + 32 * u;
      p0[u] = (pay0 && i < w1) ? __ldcs(&a.pay.ptr[0][i * a.pay.stride[0]]) : 0u;
    }
    load_buckets(r, base + lane, 32, w1, b, &unused);
#pragma unroll
    for (int u = 0; u < ST_UNROLL; ++u) {
      const int64_t i = base + lane + 32 * u;
      const bool in = i < w1;
      const StepGroups g = step_groups(in, b[u], sink);
      const bool single = in && b[u] != g.b0 && b[u] != sink;
      const uint32_t own = b[u] & (ST_OWN - 1u);
      if (single) s_own[own] = (uint8_t)lane;
      __syncwarp();
      const bool clash = single && s_own[own] != (uint8_t)lane;
      unsigned peers = b[u] == g.b0 ? g.g0 : (b[u] == sink ? g.gs : 1u << lane);
      if (__ballot_sync(dbt::FULL_MASK, clash) && in) peers = __match_any_sync(g.live, b[u]);
      if (in) {
        const int leader = __ffs(peers) - 1;
        uint32_t first = 0u;
        if (lane == leader) {
          first = s_base[b[u]] + cnt[b[u]];
          cnt[b[u]] = (uint16_t)(cnt[b[u]] + __popc(peers));
        }
        const uint32_t place = __shfl_sync(g.live, first, leader) + __popc(peers & lanes_below);
        uint32_t slot = m;
        if (b[u] < r.nparts) {
          const uint32_t rank = place - __ldg(&a.starts[b[u]]);
          if (rank < a.cap) slot = b[u] * a.cap + rank;
        }
        if (slot < m) {
          st_keep(&a.cells.ptr[0][slot], p0[u], keep);
          for (int k = 1; k < a.cells.count; ++k)
            st_keep(&a.cells.ptr[k][slot], a.pay.ptr[k][i * a.pay.stride[k]], keep);
        }
        if (a.si) st_keep(&a.si[place], (uint32_t)i, keep);
        if (a.slot_of_row) __stcs(&a.slot_of_row[i], (int32_t)slot);
      }
      __syncwarp();
    }
  }
}

int64_t stage_spans(int64_t n, int64_t span) { return n > 0 ? (n + span - 1) / span : 1; }

size_t place_bytes(int64_t nbins, int warps) {
  return (size_t)(4 * nbins + warps * (2 * (nbins + (nbins & 1)) + ST_OWN));
}

int set_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// count and scan: the matrix of r.mat scanned in place
int count_and_scan(const Rows& r, uint32_t* scan_scratch, uint32_t* stats, cudaStream_t st) {
  const int64_t nbins = (int64_t)r.nparts + 1;
  const size_t bytes = (size_t)(4 * nbins);
  cudaError_t ce = cudaMemsetAsync(r.mat, 0, (size_t)(nbins * r.nspans) * 4u, st);
  if (ce != cudaSuccess) return (int)ce;
  int err = set_shared((const void*)cells_count, bytes);
  if (err) return err;
  cells_count<<<(unsigned)r.nspans, ST_COUNT_THREADS, bytes, st>>>(r, stats);
  DBT_CHECK_LAUNCH();
  return dbt::seg_scan_launch<dbt::SumOp>(nullptr, r.mat, 4, r.mat, scan_scratch,
                                          nbins * r.nspans, false, st);
}

bool plan_ok(int64_t n, int64_t nbins, int64_t span, int64_t scratch_words, int64_t need) {
  if (span < 32 || span > ST_MAX_SPAN || n > dbt::SCAN_MAX_ROWS) return false;
  if (nbins * stage_spans(n, span) > dbt::SCAN_MAX_ROWS) return false;
  return scratch_words >= need;
}

}  // namespace

DBT_API int64_t dbt_value_boundaries_scratch_words(int64_t n, int64_t nprobes, int64_t span) {
  const int64_t entries = (nprobes + 1) * stage_spans(n, span);
  return entries + dbt::seg_scan_scratch_words(entries);
}

// out[p] = number of d[i] (as u32) below p, for p in [0, nprobes): the
// bucket starts of the count and the scan; `span` rows a count block.
DBT_API int dbt_value_boundaries(const void* d, int64_t n, int64_t nprobes, void* out,
                                 void* scratch, int64_t scratch_words, int64_t span,
                                 void* stream) {
  if (nprobes <= 0) return 0;
  const int64_t nbins = nprobes + 1;
  if (nbins * 4 > 232448 ||
      !plan_ok(n, nbins, span, scratch_words, dbt_value_boundaries_scratch_words(n, nprobes, span)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Rows r;
  r.dest = static_cast<const uint32_t*>(d);
  r.active = nullptr;
  r.count = nullptr;
  r.n = n;
  r.nparts = (uint32_t)nprobes;
  r.span = span;
  r.nspans = stage_spans(n, span);
  r.mat = static_cast<uint32_t*>(scratch);
  const int64_t entries = nbins * r.nspans;
  int err = count_and_scan(r, r.mat + entries, nullptr, st);
  if (err) return err;
  cells_finish<<<dbt::blocks_for(nbins, 256), 256, 0, st>>>(
      r, nprobes, 0u, static_cast<uint32_t*>(out), nullptr, nullptr);
  DBT_CHECK_LAUNCH();
  return 0;
}

DBT_API int64_t dbt_stage_cells_scratch_words(int64_t n, int64_t nparts, int64_t span) {
  const int64_t nbins = nparts + 1;
  const int64_t entries = nbins * stage_spans(n, span);
  return entries + dbt::seg_scan_scratch_words(entries) + nbins;
}

// dest u32[n]; active u8[n] or null (every row active); count: a device
// int32 live count or null (row i is read only if i < count); pay_in: npay
// device pointers (host array) to u32 columns of n rows with their row
// strides; cells: npay device pointers to u32[nparts * cap]; counts
// u32[nparts]; `fill` the value of every dead slot of every cell; stats
// u32[3] = (overflow, active rows with dest > nparts,
// rows of the sink bucket); si i32[n] (the rows in (bucket, row) order) or
// null; slot_of_row i32[n] or null.  `span` rows a block, `warps` warps a
// place block (kernels/cells_plan.py).
DBT_API int dbt_stage_cells(const void* dest, const void* active, const void* count, int64_t n,
                            int64_t nparts, int64_t cap, const void* const* pay_in,
                            const int64_t* pay_strides, void* const* cells, int npay,
                            uint32_t fill, void* counts,
                            void* stats, void* si, void* slot_of_row, void* scratch,
                            int64_t scratch_words, int64_t span, int warps, void* stream) {
  const int64_t nbins = nparts + 1;
  if (nparts < 1 || cap < 1 || npay < 0 || npay > dbt::MAX_KEY_WORDS)
    return (int)cudaErrorInvalidValue;
  if (nparts * cap > dbt::SCAN_MAX_ROWS ||
      !plan_ok(n, nbins, span, scratch_words, dbt_stage_cells_scratch_words(n, nparts, span)))
    return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > ST_MAX_WARPS || span % (32 * warps) != 0 ||
      place_bytes(nbins, warps) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Rows r;
  r.dest = static_cast<const uint32_t*>(dest);
  r.active = static_cast<const uint8_t*>(active);
  r.count = static_cast<const int32_t*>(count);
  r.n = n;
  r.nparts = (uint32_t)nparts;
  r.span = span;
  r.nspans = stage_spans(n, span);
  r.mat = static_cast<uint32_t*>(scratch);
  const int64_t entries = nbins * r.nspans;
  uint32_t* scan_scratch = r.mat + entries;
  uint32_t* starts = scan_scratch + dbt::seg_scan_scratch_words(entries);
  uint32_t* st_stats = static_cast<uint32_t*>(stats);
  CellPtrs cp;
  cp.count = npay;
  for (int k = 0; k < npay; ++k) cp.ptr[k] = static_cast<uint32_t*>(cells[k]);

  cudaError_t ce = cudaMemsetAsync(st_stats, 0, 3 * sizeof(uint32_t), st);
  if (ce != cudaSuccess) return (int)ce;
  int err = count_and_scan(r, scan_scratch, st_stats, st);
  if (err) return err;
  cells_finish<<<dbt::blocks_for(nbins, 256), 256, 0, st>>>(
      r, nbins, (uint32_t)cap, starts, static_cast<uint32_t*>(counts), st_stats);
  DBT_CHECK_LAUNCH();
  if (n > 0) {
    PlaceArgs a;
    a.r = r;
    a.starts = starts;
    a.cap = (uint32_t)cap;
    a.pay = dbt::key_cols(pay_in, pay_strides, npay);
    a.cells = cp;
    a.si = static_cast<int32_t*>(si);
    a.slot_of_row = static_cast<int32_t*>(slot_of_row);
    const size_t bytes = place_bytes(nbins, warps);
    err = set_shared((const void*)cells_place, bytes);
    if (err) return err;
    cells_place<<<(unsigned)r.nspans, 32 * warps, bytes, st>>>(a);
    DBT_CHECK_LAUNCH();
  }
  if (npay > 0) {
    const dim3 fill_grid(dbt::blocks_for(cap, ST_FILL_CHUNK), (unsigned)nparts);
    cells_fill_dead<<<fill_grid, ST_FILL_THREADS, 0, st>>>(static_cast<const uint32_t*>(counts),
                                                           cap, cp, fill);
    DBT_CHECK_LAUNCH();
  }
  return 0;
}
