"""The launch plan and refusals of the distributed plan's kernels: K19, the
top-k runs of a sorted hash column (``csrc/topk_runs.cu``), K20 and K21, the
skew join's hot-hash list and membership in it (``csrc/hot_set.cu``), and
K22, the distributed sort's range destination (``csrc/range_dest.cu``).

- K19 is one launch: a block owns ``TOPK_TILE`` positions, a warp
  ``TOPK_WARP_SPAN`` of them in steps of 32, and finds each run's length
  from the start flags (the next start, or nact; only the tile's last run
  looks past the tile).  Up to ``TOPK_WARP_K`` picks, each warp keeps its k
  largest (count, position) keys in registers and the block merges the
  warps' lists by one bitonic sort; beyond, the block keeps a list of k
  keys and a buffer of entrants in ``TOPK_BIG_SORT`` keys of shared memory,
  ``TOPK_BIG_ROUND`` keys a thread a round, sorted whenever the next round
  could fill the buffer, which caps k at ``TOPK_MAX_K``.
  Every block writes its k keys to scratch (``topk_scratch_words``, after
  the done counter) and the last block to finish takes the k largest of
  all of them the same way.
- K20 holds the all-gathered candidates (hash and count, 8 bytes each) in
  shared memory, K21 the hot list (4 bytes an entry), K22 the splitters
  (4 bytes a word of each), each at most ``SHARED_BYTES``.
- K22 takes one of two paths (``range_plan``).  Where every key column is
  contiguous and 16-byte aligned, as num and recid are, and so is the
  output, a thread reads ``RANGE_ROWS`` = 4 rows by one 16-byte load a
  word and writes their destinations as one 16-byte store; the thread just
  past the last whole group takes the ``n % 4`` rows of the tail one by
  one.  Otherwise (string words, columns of the row-major strw matrix, or a
  view that starts off 16 bytes) a thread takes ``RANGE_ROWS`` rows,
  ``RANGE_THREADS`` apart, by 4-byte loads.  The grid covers the rows once.

The C entries repeat these checks; ``tests/test_torch_dist_schedule.py``
emulates the four kernels with them on the CPU.
"""

from __future__ import annotations

SHARED_BYTES = 232448  # dynamic shared memory a block may use on the H100
MAX_ROWS = (1 << 31) - 1  # rows and positions are 32-bit on the card
TOPK_THREADS = 256  # K19's block (THREADS in csrc/topk_runs.cu)
TOPK_WARP_SPAN = 512  # K19: positions a warp, 16 steps of 32 (WARP_SPAN)
TOPK_TILE = TOPK_THREADS // 32 * TOPK_WARP_SPAN  # K19: positions a block (TILE)
TOPK_WARP_K = 32  # K19: picks up to which a warp keeps its list in registers (SMALL_K)
TOPK_BIG_SORT = 4096  # K19: keys of a block's list and buffer past TOPK_WARP_K (BIG_SORT)
TOPK_BIG_ROUND = 4  # K19: keys a thread offers the block's list a round (BIG_ROUND)
TOPK_MAX_K = 1024  # K19: picks (MAX_K): the list and a round's entrants fit TOPK_BIG_SORT
HOT_MAX_CANDIDATES = SHARED_BYTES // 8  # K20
IN_SET_MAX_HOT = (SHARED_BYTES - 16) // 4  # K21 (16 bytes for the block's count)
RANGE_MAX_WORDS = 4  # K22's key words (MAX_WORDS in csrc/range_dest.cu)
RANGE_THREADS = 256  # K22's block (THREADS in csrc/range_dest.cu)
RANGE_ROWS = 4  # K22's rows a thread (ROWS in csrc/range_dest.cu): one 16-byte load a word


def topk_tiles(n: int) -> int:
    return max(-(-n // TOPK_TILE), 1)


def topk_scratch_words(n: int, k: int) -> int:
    """K19's scratch in 32-bit words: the done counter (zeroed by a memset of
    4 bytes) and a word that brings the keys to 8 bytes, then one 64-bit key
    a tile and pick."""
    return 2 + 2 * topk_tiles(n) * k


def check_topk(name: str, n: int, k: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{name}: {n} rows; K19's positions are 32-bit (at most {MAX_ROWS})")
    if not 1 <= k <= min(n, TOPK_MAX_K):
        raise ValueError(f"{name}: k = {k} for {n} rows; K19 takes 1 <= k <= min(rows, "
                         f"{TOPK_MAX_K}): past {TOPK_WARP_K} a block keeps its k picks in "
                         f"shared memory")


def check_candidates(name: str, m: int) -> None:
    if m > HOT_MAX_CANDIDATES:
        raise ValueError(f"{name}: {m} candidates; K20 holds them in shared memory, 8 bytes "
                         f"each, at most {HOT_MAX_CANDIDATES} (ndev * hh_topk)")


def check_hot_list(name: str, n: int, mh: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{name}: {n} rows; K21's rows are at most {MAX_ROWS}")
    if mh > IN_SET_MAX_HOT:
        raise ValueError(f"{name}: a hot list of {mh} entries; K21 holds it in shared memory, "
                         f"4 bytes an entry, at most {IN_SET_MAX_HOT}")


def check_splitters(name: str, n: int, nw: int, ns: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{name}: {n} rows; K22's rows are at most {MAX_ROWS}")
    if not 1 <= nw <= RANGE_MAX_WORDS:
        raise ValueError(f"{name}: {nw} key words; K22 compares 1-{RANGE_MAX_WORDS}")
    if 4 * nw * ns > SHARED_BYTES:
        raise ValueError(f"{name}: {ns} splitters of {nw} words; K22 holds them in shared "
                         f"memory, at most {SHARED_BYTES} bytes")


def range_plan(n: int, ptrs, strides, dest_ptr: int) -> tuple[bool, int]:
    """(vector path, blocks) of K22 over n rows.  The vector
    path takes every key column contiguous (row stride 1) and, like the
    output, 16-byte aligned.  `ptrs` and `dest_ptr` are byte addresses,
    `strides` row strides in words."""
    vec = (all(s == 1 for s in strides) and all(p % 16 == 0 for p in ptrs)
           and dest_ptr % 16 == 0)
    return vec, max(-(-n // (RANGE_THREADS * RANGE_ROWS)), 1)
