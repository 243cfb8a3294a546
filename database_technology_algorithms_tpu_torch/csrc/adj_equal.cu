// K6: exact adjacent-key equality under a permutation.
//
// Replaces the JAX package's rows_equal_on_field(batch, field, perm[:-1],
// perm[1:]) with its leading False (ops/keys.py:68-78, used by sort_keys at
// ops/sort.py:128-133,173,179-180): two whole-row gathers of the key
// columns and an all-reduce over the words.  adj[i] is true when sorted row
// i has the same full key as sorted row i-1; adj[0] is false.  A null perm
// compares the rows where they lie (ops/keys.py:81 adjacent_equal).
//
// Bound on the H100: bytes.  Per row it must read the 4-byte perm entry and
// the m key words of the row, and write one byte.  Through perm every row is
// a random sector, so what the card waits on is the number of sectors and
// the latency of two chained loads (perm, then the row).  The design
// (kernels/perm_plan.py):
//   - a warp owns 32 * R consecutive sorted rows, warp-striped (lane L holds
//     rows L, L + 32, ...): every load of perm, of rows in place and every
//     store is one coalesced run, and a lane has R rows' loads in flight
//     before it compares any;
//   - each row is read once: the predecessor of a row is the lane below's
//     row of the same step, by a shuffle (lane 0's is lane 31's row of the
//     step before), and lane 0 reads the one predecessor that lies before
//     the warp;
//   - the key is compared in stages, each up to CHUNK words that lie
//     together in a row (strw[:, j], j = k, k+1, ...) and load as the
//     host's 16-, 8- or 4-byte vectors with no compare between them; a row
//     loads a later stage only while its own compare or its successor's is
//     open, so a key whose first words lie apart (field 3's num) reads the
//     rest only where they tie;
//   - a stage's vectors are a pattern known to the compiler (one of twelve,
//     picked once a stage), and the keys of the main path are kernels of
//     their own with every stage known: a one-stage key of one vector
//     (fields 0-2), and num beside one strw vector (field 3).  So a row
//     costs its loads and a few instructions: at 2M rows in place the
//     kernel is bound by its instructions, not by the bytes.
#include "common.cuh"

namespace {

constexpr int ADJ_THREADS = 256;
constexpr int CHUNK = 4;  // perm_plan.CHUNK_WORDS: the most words of a stage

// R, rows a lane (perm_plan.ADJ_ROWS); tools/perm_sweep.py builds copies
// with other values
#ifndef ADJ_R
#define ADJ_R 2
#endif

// A stage's vectors as hex digits, the first lowest: 0x21 is a 4-byte word
// then an 8-byte pair (perm_plan.stage_patterns).  The twelve ways to cut 1
// to 4 words into vectors of 1, 2 and 4 words, a 4 only alone.
#define DBT_STAGE_PATTERNS(X)                                                          \
  X(0x1) X(0x2) X(0x11) X(0x4) X(0x12) X(0x21) X(0x111) X(0x22) X(0x112) X(0x121) \
      X(0x211) X(0x1111)

// The key words: a pointer and row stride (in words) a word, the stages'
// first words (stage[nstages] = count) and patterns.
struct KeyPlan {
  const uint32_t* ptr[dbt::MAX_KEY_WORDS];
  int64_t stride[dbt::MAX_KEY_WORDS];
  int8_t stage[dbt::MAX_KEY_WORDS + 1];
  int16_t pattern[dbt::MAX_KEY_WORDS];
  int count;
  int nstages;
};

// The words of row a of the stage that starts at key word `first`, cut as
// PAT says, into w[0, words).
template <int PAT>
__device__ __forceinline__ void load_pattern(const KeyPlan& p, int first, uint32_t a,
                                             uint32_t (&w)[CHUNK]) {
  int kk = 0;
#pragma unroll
  for (int q = 0; q < CHUNK; ++q) {
    const int v = (PAT >> (4 * q)) & 0xF;
    if (v == 0) break;
    const uint32_t* at = p.ptr[first + kk] + (int64_t)a * p.stride[first + kk];
    if (v == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(at);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    } else if (v == 2) {
      const uint2 x = *reinterpret_cast<const uint2*>(at);
      w[kk] = x.x;
      w[kk + 1] = x.y;
    } else {
      w[kk] = *at;
    }
    kk += v;
  }
}

// One stage's loads for the lane's rows that need them, and lane 0's
// predecessor row before the warp.
template <int R, int PAT>
__device__ __forceinline__ void load_rows(const KeyPlan& p, int first, const uint32_t (&a)[R],
                                          const bool (&load)[R], bool load_prev, uint32_t a_prev,
                                          uint32_t (&w)[R][CHUNK], uint32_t (&wp)[CHUNK]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (load[r]) load_pattern<PAT>(p, first, a[r], w[r]);
  if (load_prev) load_pattern<PAT>(p, first, a_prev, wp);
}

template <int R>
__device__ __forceinline__ void load_any(int pattern, const KeyPlan& p, int first,
                                         const uint32_t (&a)[R], const bool (&load)[R],
                                         bool load_prev, uint32_t a_prev,
                                         uint32_t (&w)[R][CHUNK], uint32_t (&wp)[CHUNK]) {
  switch (pattern) {
#define DBT_CASE(PAT)                                                 \
  case PAT:                                                           \
    load_rows<R, PAT>(p, first, a, load, load_prev, a_prev, w, wp); \
    break;
    DBT_STAGE_PATTERNS(DBT_CASE)
#undef DBT_CASE
  }
}

__device__ __forceinline__ bool stage_equal(const uint32_t (&x)[CHUNK], const uint32_t (&y)[CHUNK],
                                            int words) {
  bool eq = true;
#pragma unroll
  for (int kk = 0; kk < CHUNK; ++kk)
    if (kk < words) eq &= x[kk] == y[kk];
  return eq;
}

// The words of a stage pattern.
__host__ __device__ constexpr int pattern_words(int pat) {
  return (pat & 0xF) + ((pat >> 4) & 0xF) + ((pat >> 8) & 0xF) + ((pat >> 12) & 0xF);
}

// A lane's state: its rows (sorted index j, key row a, in range, compare
// still equal), their words of the current stage, and lane 0's predecessor
// row before the warp.
template <int R>
struct Lane {
  uint32_t lane;
  uint32_t j[R];  // below 2^31 + 256: no wrap
  uint32_t a[R];
  bool in[R];
  bool e[R];
  bool outside;  // lane 0 of a warp past the first
  uint32_t a_prev;
  uint32_t w[R][CHUNK];
  uint32_t wp[CHUNK];
};

// Stage s of the key (words [first, first + words)), whose vectors are PAT,
// or p.pattern[s] where PAT is 0.  MULTI: the key has more stages, so a row
// loads this one only while its own compare or its successor's is open, and
// false comes back, with nothing loaded, once no compare of the warp is open.
template <int R, bool MULTI, int PAT>
__device__ __forceinline__ bool run_stage(const KeyPlan& p, int s, int first, int words,
                                          Lane<R>& L) {
  // the successor of (r, lane) is (r, lane + 1), of (r, 31) (r + 1, 0)
  bool load[R];
  if (MULTI) {
    bool open = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool right = __shfl_down_sync(dbt::FULL_MASK, L.e[r], 1);
      const bool next_step = r + 1 < R ? L.e[(r + 1) % R] : false;
      const bool wrap = __shfl_sync(dbt::FULL_MASK, next_step, 0);
      load[r] = L.in[r] && (L.e[r] || (L.lane < 31 ? right : wrap));
      open |= L.e[r];
    }
    if (!__any_sync(dbt::FULL_MASK, open)) return false;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) load[r] = L.in[r];
  }
  const bool load_prev = L.outside && L.e[0];
  if constexpr (PAT != 0)
    load_rows<R, PAT>(p, first, L.a, load, load_prev, L.a_prev, L.w, L.wp);
  else
    load_any<R>(p.pattern[s], p, first, L.a, load, load_prev, L.a_prev, L.w, L.wp);
  // the predecessors, step by step: lane 0's of step r is lane 31's row of
  // step r - 1, which the shuffle of step r - 1 brought to it
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t pr[CHUNK];
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) {
      if (kk < words) {  // the same for every lane
        const uint32_t x = __shfl_sync(dbt::FULL_MASK, L.w[r][kk], (L.lane + 31) & 31);
        pr[kk] = L.lane ? x : L.wp[kk];
        L.wp[kk] = x;
      }
    }
    L.e[r] = L.e[r] && stage_equal(L.w[r], pr, words);
  }
  return true;
}

// NS: the key's stages where the compiler knows them, with their patterns
// PAT0 and PAT1 (0: read from the plan): 1, a one-stage key; 2, field 3's
// num beside one strw stage; 0, any key, its stages read from the plan.
template <int R, int NS, int PAT0, int PAT1>
__global__ void __launch_bounds__(ADJ_THREADS)
    adj_equal_kernel(const KeyPlan p, const int32_t* perm, uint32_t n, uint8_t* adj) {
  Lane<R> L;
  L.lane = threadIdx.x & 31;
  const uint32_t warp_first = (blockIdx.x * ADJ_THREADS + (threadIdx.x & ~31u)) * R;
  if (warp_first >= n) return;  // the whole warp: the shuffles see every lane
#pragma unroll
  for (int r = 0; r < R; ++r) {
    L.j[r] = warp_first + r * 32 + L.lane;
    L.in[r] = L.j[r] < n;
    L.a[r] = L.in[r] ? (perm ? (uint32_t)perm[L.j[r]] : L.j[r]) : 0u;
    L.e[r] = L.in[r] && L.j[r] > 0;
  }
  // lane 0's first predecessor, the last row of the warp below
  L.outside = L.lane == 0 && warp_first > 0;
  L.a_prev = 0u;
  if (L.outside) L.a_prev = perm ? (uint32_t)perm[warp_first - 1] : warp_first - 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kk = 0; kk < CHUNK; ++kk) L.w[r][kk] = 0u;
#pragma unroll
  for (int kk = 0; kk < CHUNK; ++kk) L.wp[kk] = 0u;

  if constexpr (NS == 1) {  // a one-stage key's words are the key's
    run_stage<R, false, PAT0>(p, 0, 0, p.count, L);
  } else if constexpr (NS == 2) {  // every index known to the compiler
    if (run_stage<R, true, PAT0>(p, 0, 0, pattern_words(PAT0), L))
      run_stage<R, true, PAT1>(p, 1, pattern_words(PAT0), pattern_words(PAT1), L);
  } else {
    for (int s = 0; s < p.nstages; ++s)
      if (!run_stage<R, true, 0>(p, s, p.stage[s], p.stage[s + 1] - p.stage[s], L)) break;
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (L.in[r]) adj[L.j[r]] = L.e[r];
}

template <int R>
void launch(const KeyPlan& p, const int32_t* perm, uint32_t n, uint8_t* adj, cudaStream_t st) {
  const unsigned blocks = dbt::blocks_for(n, (int64_t)ADJ_THREADS * R);
  const int p0 = p.pattern[0], p1 = p.nstages == 2 ? p.pattern[1] : 0;
#define DBT_LAUNCH(NS, PAT0, PAT1) \
  adj_equal_kernel<R, NS, PAT0, PAT1><<<blocks, ADJ_THREADS, 0, st>>>(p, perm, n, adj)
  if (p.nstages == 1) {
    if (p0 == 0x1) DBT_LAUNCH(1, 0x1, 0);
    else if (p0 == 0x2) DBT_LAUNCH(1, 0x2, 0);
    else if (p0 == 0x4) DBT_LAUNCH(1, 0x4, 0);
    else DBT_LAUNCH(1, 0, 0);
  } else if (p0 == 0x1 && p1 == 0x1) {
    DBT_LAUNCH(2, 0x1, 0x1);
  } else if (p0 == 0x1 && p1 == 0x2) {
    DBT_LAUNCH(2, 0x1, 0x2);
  } else if (p0 == 0x1 && p1 == 0x4) {
    DBT_LAUNCH(2, 0x1, 0x4);
  } else {
    DBT_LAUNCH(0, 0, 0);
  }
#undef DBT_LAUNCH
}

bool known_pattern(int pattern) {
  switch (pattern) {
#define DBT_CASE(PAT) case PAT:
    DBT_STAGE_PATTERNS(DBT_CASE)
#undef DBT_CASE
    return true;
  }
  return false;
}

}  // namespace

// words: m device pointers (host array) to u32 columns and the row stride
// of each in `strides` (host array, in words); `stages` (host array of
// nstages + 1): each stage's first word, then m; `patterns` (host array of
// nstages): each stage's vectors (kernels/perm_plan.key_plan); perm i32[n]
// or null; adj u8[n]; rows: R, which must be ADJ_R.
DBT_API int dbt_adj_equal(const void* const* words, const int64_t* strides, const int* patterns,
                          const int* stages, int nstages, int m, const void* perm, int64_t n,
                          void* adj, int rows, void* stream) {
  if (m < 1 || m > dbt::MAX_KEY_WORDS || n > INT32_MAX || nstages < 1 || nstages > m ||
      rows != ADJ_R)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  KeyPlan p;
  p.count = m;
  p.nstages = nstages;
  for (int k = 0; k < m; ++k) {
    p.ptr[k] = static_cast<const uint32_t*>(words[k]);
    p.stride[k] = strides[k];
  }
  // the stages cover the words in order, each 1 to CHUNK of them, cut into
  // vectors whose words lie together on aligned addresses
  if (stages[0] != 0 || stages[nstages] != m) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < nstages; ++s) {
    const int first = stages[s], end = stages[s + 1];
    if (end - first < 1 || end - first > CHUNK || !known_pattern(patterns[s]))
      return (int)cudaErrorInvalidValue;
    int k = first;
    for (int q = 0; q < CHUNK && (patterns[s] >> (4 * q)) & 0xF; ++q) {
      const int v = (patterns[s] >> (4 * q)) & 0xF;
      if (k + v > end || (uintptr_t)words[k] % (4 * v) || strides[k] % v)
        return (int)cudaErrorInvalidValue;
      for (int i = 1; i < v; ++i)
        if (static_cast<const uint32_t*>(words[k + i]) != p.ptr[k] + i ||
            strides[k + i] != strides[k])
          return (int)cudaErrorInvalidValue;
      k += v;
    }
    if (k != end) return (int)cudaErrorInvalidValue;
    p.stage[s] = (int8_t)first;
    p.pattern[s] = (int16_t)patterns[s];
  }
  p.stage[nstages] = (int8_t)m;
  const int32_t* pm = static_cast<const int32_t*>(perm);
  uint8_t* out = static_cast<uint8_t*>(adj);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch<ADJ_R>(p, pm, (uint32_t)n, out, st);
  DBT_CHECK_LAUNCH();
  return 0;
}
