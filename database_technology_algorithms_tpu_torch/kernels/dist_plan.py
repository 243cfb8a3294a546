"""The launch plan and refusals of the distributed plan's kernels: K19, the
top-k runs of a sorted hash column (``csrc/topk_runs.cu``), K20 and K21, the
skew join's hot-hash list and membership in it (``csrc/hot_set.cu``), and
K22, the distributed sort's range destination (``csrc/range_dest.cu``).

- K19's first pass gives each block ``TOPK_TILE`` positions and keeps the
  block's k largest (count, position) keys in ``topk_scratch_words``; its
  second pass, one block, takes the k largest of those.  Each of the k
  picks is one block-wide reduction, so k is capped at ``TOPK_MAX_K``.
- K20 holds the all-gathered candidates (hash and count, 8 bytes each) in
  shared memory, K21 the hot list (4 bytes an entry), K22 the splitters
  (4 bytes a word of each), each at most ``SHARED_BYTES``.

The C entries repeat these checks; ``tests/test_torch_dist_schedule.py``
emulates the four kernels with them on the CPU.
"""

from __future__ import annotations

SHARED_BYTES = 232448  # dynamic shared memory a block may use on the H100
MAX_ROWS = (1 << 31) - 1  # rows and positions are 32-bit on the card
TOPK_TILE = 4096  # K19: 256 threads x 16 positions (TILE in csrc/topk_runs.cu)
TOPK_MAX_K = 1024  # K19: picks, one block-wide reduction each
HOT_MAX_CANDIDATES = SHARED_BYTES // 8  # K20
IN_SET_MAX_HOT = (SHARED_BYTES - 16) // 4  # K21 (16 bytes for the block's count)
RANGE_MAX_WORDS = 4  # K22's key words (MAX_WORDS in csrc/range_dest.cu)


def topk_tiles(n: int) -> int:
    return max(-(-n // TOPK_TILE), 1)


def topk_scratch_words(n: int, k: int) -> int:
    """K19's scratch in 32-bit words: one 64-bit key a tile and pick."""
    return 2 * topk_tiles(n) * k


def check_topk(name: str, n: int, k: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{name}: {n} rows; K19's positions are 32-bit (at most {MAX_ROWS})")
    if not 1 <= k <= min(n, TOPK_MAX_K):
        raise ValueError(f"{name}: k = {k} for {n} rows; K19 takes 1 <= k <= min(rows, "
                         f"{TOPK_MAX_K}), one block-wide reduction a pick")


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
