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
- K20 takes one of two modes (``hot_plan``).  Where both sides' candidates
  together fit one block of ``HOT_THREADS`` (the path's 2 * ndev * hh_topk),
  one block stages both, a thread a candidate, and its last barrier counts
  the list's live entries (block mode: one launch, no memset, no atomic).
  Past that, up to ``HOT_MAX_CANDIDATES`` a side, a block of
  ``HOT_THREADS`` takes a chunk of one side and stages that side whole; the
  blocks add their counts to a zeroed word (grid mode: a memset and the
  launch).
- K21 takes one of two paths and one of two modes (``in_set_plan``).  A
  thread takes ``IN_SET_ROWS`` = 8 rows a step: where the hashes are
  contiguous and 16-byte aligned (the vector path) by two 16-byte loads
  and one 8-byte store of the 8 bools, the thread just past the last whole
  group taking the ``n % 8`` rows of the tail one by one; otherwise (a view
  off 16 bytes) ``IN_SET_ROWS`` rows a thread, a block's width apart.  A
  list of at most ``IN_SET_SCAN_MAX`` entries (the path's ``2 * ndev *
  hh_topk`` up to 8 shards) is staged as its live entries, by warp ballots,
  and scanned, in a grid of ``IN_SET_THREADS`` that covers the rows once;
  a longer one's live entries (all its entries where the warps' counts do
  not fit beside them) are sorted in each block's shared memory and
  searched, in a persistent grid of ``IN_SET_SEARCH_THREADS`` whose blocks
  fit an SM beside their copy of the list.
- K22 takes one of two paths (``range_plan``).  Where every key column is
  contiguous and 16-byte aligned, as num and recid are, and so is the
  output, a thread reads ``RANGE_ROWS`` = 4 rows by one 16-byte load a
  word and writes their destinations as one 16-byte store; the thread just
  past the last whole group takes the ``n % 4`` rows of the tail one by
  one.  Otherwise (string words, columns of the row-major strw matrix, or a
  view that starts off 16 bytes) a thread takes ``RANGE_ROWS`` rows,
  ``RANGE_THREADS`` apart, by 4-byte loads.  The grid covers the rows once.

Past a kernel's shared-memory limit the wrappers take another form, chosen
here from the limit constants alone, so that the CPU (whose plain versions
take any size) walks the card's path when a test shrinks a constant:

- K19 past ``TOPK_MAX_K`` picks (``topk_by_sort``): the run starts
  compacted (K3), each run's length the distance to the next start, a sort
  by (count descending, position) (K1), the first k;
- K20 past ``HOT_MAX_CANDIDATES`` candidates a side (``hot_by_sort``): each
  side's candidates sorted by hash (K1), each hash's total by a reversed
  segmented sum (K2), the decisions scattered back to the candidates (K7);
- K21 past ``IN_SET_MAX_HOT`` entries (``in_set_by_sort``): the list's live
  entries sorted (K1) and each row's hash searched in them (K15);
- K22 past ``RANGE_SPLITTER_BYTES`` of splitters (``range_round``): rounds
  of splitters, whose destinations add up.

The C entries repeat these checks; ``tests/test_torch_dist_schedule.py``
emulates the four kernels with them on the CPU, and
``tests/test_torch_limits.py`` holds the other forms against the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

from .engines_plan import BLOCK_RESERVED_BYTES, H100_SMS, SM_SHARED_BYTES, SM_THREADS

SHARED_BYTES = 232448  # dynamic shared memory a block may use on the H100
MAX_ROWS = (1 << 31) - 1  # rows and positions are 32-bit on the card
TOPK_THREADS = 256  # K19's block (THREADS in csrc/topk_runs.cu)
TOPK_WARP_SPAN = 512  # K19: positions a warp, 16 steps of 32 (WARP_SPAN)
TOPK_TILE = TOPK_THREADS // 32 * TOPK_WARP_SPAN  # K19: positions a block (TILE)
TOPK_WARP_K = 32  # K19: picks up to which a warp keeps its list in registers (SMALL_K)
TOPK_BIG_SORT = 4096  # K19: keys of a block's list and buffer past TOPK_WARP_K (BIG_SORT)
TOPK_BIG_ROUND = 4  # K19: keys a thread offers the block's list a round (BIG_ROUND)
TOPK_MAX_K = 1024  # K19: picks (MAX_K): the list and a round's entrants fit TOPK_BIG_SORT
HOT_MAX_CANDIDATES = SHARED_BYTES // 8  # K20, a side
HOT_THREADS = 1024  # K20: block mode's most candidates, grid mode's block (csrc/hot_set.cu)
IN_SET_MAX_HOT = (SHARED_BYTES - 16) // 4  # K21: the list in shared memory, 4 bytes an entry
IN_SET_ROWS = 8  # K21's rows a thread a step (1, 2, 4 or 8): two 16-byte loads at 8
IN_SET_THREADS = 128  # K21's block in scan mode
IN_SET_SEARCH_THREADS = 1024  # K21's block in search mode (IN_MAX_THREADS in csrc/hot_set.cu)
IN_SET_SCAN_MAX = 256  # K21: entries up to which it scans the live ones; past it, it searches
IN_SET_BLOCKS = 0  # K21: a cap on the grid (0: none), so that a thread takes several steps
RANGE_MAX_WORDS = 4  # K22's key words (MAX_WORDS in csrc/range_dest.cu)
RANGE_THREADS = 256  # K22's block (THREADS in csrc/range_dest.cu)
RANGE_ROWS = 4  # K22's rows a thread (ROWS in csrc/range_dest.cu): one 16-byte load a word
RANGE_SPLITTER_BYTES = SHARED_BYTES  # K22's splitters a launch, 4 bytes a word of each


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
    if not 1 <= k <= n:
        raise ValueError(f"{name}: k = {k} for {n} rows; K19 (and past {TOPK_MAX_K} its sort "
                         f"form) takes 1 <= k <= rows")


def topk_by_sort(k: int) -> bool:
    """Whether the top k runs come from a sort of the runs (K3, K1) and not
    from K19, whose block keeps its k picks in shared memory: k past
    ``TOPK_MAX_K``."""
    return k > TOPK_MAX_K


def check_candidates(name: str, m: int) -> None:
    if m > HOT_MAX_CANDIDATES:
        raise ValueError(f"{name}: {m} candidates; K20 holds them in shared memory, 8 bytes "
                         f"each, at most {HOT_MAX_CANDIDATES} (ndev * hh_topk)")


def hot_by_sort(m_p: int, m_b: int) -> bool:
    """Whether the hot lists come from a sort of each side's candidates (K1,
    K2, K7) and not from K20, which holds a side's candidates in shared
    memory: a side past ``HOT_MAX_CANDIDATES``."""
    return max(m_p, m_b) > HOT_MAX_CANDIDATES


class HotPlan(NamedTuple):
    block: bool  # one block holds both sides' candidates, else a block a chunk of one side
    threads: int
    blocks: int
    shared_bytes: int  # the candidates a block stages, 8 bytes each


def hot_plan(m_p: int, m_b: int, name: str = "hot_lists") -> HotPlan:
    """K20's plan for m_p probe-side and m_b build-side candidates (m_b 0 for
    one side alone).  Raises ValueError on what the kernel refuses."""
    check_candidates(name, m_p)
    check_candidates(name, m_b)
    m = m_p + m_b
    if m <= HOT_THREADS:
        return HotPlan(True, max(-(-m // 32) * 32, 32), 1, 8 * m)
    return HotPlan(False, HOT_THREADS, -(-m_p // HOT_THREADS) + -(-m_b // HOT_THREADS),
                   8 * max(m_p, m_b))


def check_hot_list(name: str, n: int, mh: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{name}: {n} rows; K21's rows are at most {MAX_ROWS}")
    if mh > IN_SET_MAX_HOT:
        raise ValueError(f"{name}: a hot list of {mh} entries; K21 holds it in shared memory, "
                         f"4 bytes an entry, at most {IN_SET_MAX_HOT}")


def in_set_by_sort(mh: int) -> bool:
    """Whether membership goes through the list's live entries sorted (K1)
    and searched (K15) and not through K21, which holds the list in shared
    memory: a list past ``IN_SET_MAX_HOT`` entries."""
    return mh > IN_SET_MAX_HOT


def check_splitters(name: str, n: int, nw: int, ns: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{name}: {n} rows; K22's rows are at most {MAX_ROWS}")
    if not 1 <= nw <= RANGE_MAX_WORDS:
        raise ValueError(f"{name}: {nw} key words; K22 compares 1-{RANGE_MAX_WORDS}")
    if 4 * nw * ns > RANGE_SPLITTER_BYTES:
        raise ValueError(f"{name}: {ns} splitters of {nw} words; K22 holds them in shared "
                         f"memory, at most {RANGE_SPLITTER_BYTES} bytes (range_round)")


def range_round(nw: int, ns: int) -> int:
    """The splitters of a K22 launch: all `ns` where their ``4 * nw * ns``
    bytes fit ``RANGE_SPLITTER_BYTES``, else the most that do; a row's
    destination is a sum over the splitters, so the rounds' add up."""
    return max(min(ns, RANGE_SPLITTER_BYTES // (4 * max(nw, 1))), 1)


def range_plan(n: int, ptrs, strides, dest_ptr: int) -> tuple[bool, int]:
    """(vector path, blocks) of K22 over n rows.  The vector
    path takes every key column contiguous (row stride 1) and, like the
    output, 16-byte aligned.  `ptrs` and `dest_ptr` are byte addresses,
    `strides` row strides in words."""
    vec = (all(s == 1 for s in strides) and all(p % 16 == 0 for p in ptrs)
           and dest_ptr % 16 == 0)
    return vec, max(-(-n // (RANGE_THREADS * RANGE_ROWS)), 1)


class InSetPlan(NamedTuple):
    rows: int  # rows a thread a step
    vec: bool  # R rows by one load of 4R bytes (two of 16 at R = 8), one R-byte store
    search: bool  # the list sorted in shared memory and searched, else its live entries scanned
    threads: int
    blocks: int


def in_set_plan(n: int, mh: int, hashes_ptr: int, out_ptr: int) -> InSetPlan:
    """K21's plan over n rows and a list of mh entries, from the ``IN_SET_*``
    constants.  The vector path takes the hashes aligned to ``4 * rows``
    bytes (16 at most) and the output to ``rows``; scan mode covers the rows
    once, search mode takes the blocks that fit the SMs beside their list
    (at most one a row chunk); ``IN_SET_BLOCKS`` caps either.  Raises
    ValueError on what the kernel refuses."""
    rows = IN_SET_ROWS
    if rows not in (1, 2, 4, 8):
        raise ValueError(f"in_hot_set: {rows} rows a thread; the kernel takes 1, 2, 4 or 8")
    search = mh > IN_SET_SCAN_MAX
    threads = IN_SET_SEARCH_THREADS if search else IN_SET_THREADS
    if threads < 32 or threads > 1024 or threads % 32:
        raise ValueError(f"in_hot_set: {threads} threads a block; the kernel takes whole "
                         f"warps, at most 1024")
    vec = hashes_ptr % min(4 * rows, 16) == 0 and out_ptr % rows == 0
    blocks = max(-(-n // (threads * rows)), 1)
    if search:
        fit = min(SM_SHARED_BYTES // (4 * max(mh, 1) + BLOCK_RESERVED_BYTES),
                  SM_THREADS // threads)
        blocks = min(blocks, max(fit, 1) * H100_SMS)
    if IN_SET_BLOCKS:
        blocks = min(blocks, IN_SET_BLOCKS)
    return InSetPlan(rows, vec, search, threads, blocks)
