"""The tile plan of K2, the single-pass segmented scan (``csrc/scan.cuh``,
``seg_scan.py``), and of K3, the counted tile compaction (``csrc/compact.cu``,
``compact.py``).

Both kernels cut the rows into tiles of ``TILE`` rows, ``THREADS`` threads a
block.  In a tile, a thread owns ``GROUPS`` vectors of ``VEC`` rows,
warp-striped: group k of warp w is the ``LANES * VEC`` rows from
``w * LANES * ITEMS + k * LANES * VEC``, lane L holding ``VEC`` of them, so
that a warp reads and writes a group as one run (16-byte accesses for u32
columns, 4-byte ones for flags and bools).

- K2 runs one block a tile in scan order: a block takes the next tile from
  an atomic counter, scans it in registers (a thread's rows, the warp's
  lanes, a carry over the groups, the warps' totals), publishes the tile's
  aggregate and then its inclusive prefix as one 64-bit status word, and
  finds its own exclusive prefix by decoupled look-back over the earlier
  tiles' words, ``WINDOW`` at a time, stopping at the first inclusive prefix
  or at the first aggregate that holds a run start; a tile whose first row
  starts a run looks back not at all.  ``reverse`` takes the tiles from the
  last to the first (``tile_rows``) and mirrors each tile's rows.
- K3 counts the kept rows of every tile (launch 1, whose last block turns
  the counts into exclusive offsets and the total, ``TILE`` counts a round),
  then ranks each tile's rows by warp ballots over the same layout and moves
  the kept and dropped rows to ``offset + rank`` and ``total + tile start -
  offset + rank`` (launch 2).

The wrappers hand the plan's tile size and scratch size to the C entries,
which refuse a plan that differs from their own; the CPU tests emulate the
kernels tile by tile with it (``tests/test_torch_scan_schedule.py``).

K14, the expansion sources (``csrc/expand_sources.cu``,
``expand_sources.py``), is a merge of the output positions and the cumsum
``c``: ``expand_plan`` gives its block (``EXPAND_THREADS``), its merge
items a thread (``EXPAND_ITEMS``) and a grid of one block a run of
``threads * items`` merge items, all kernel arguments, chosen by
``tools/expand_sweep.py`` (``tests/test_torch_expand_schedule.py``
emulates the kernel under every plan the sweep tries).
"""

from __future__ import annotations

from typing import NamedTuple

THREADS = 256  # SCAN_THREADS in csrc/scan.cuh
ITEMS = 16  # SCAN_ITEMS: rows a thread owns
LANES = 32  # a warp
WARPS = THREADS // LANES  # SCAN_WARPS
VEC = 4  # rows of one vector
GROUPS = ITEMS // VEC  # SCAN_GROUPS: vectors a thread owns
TILE = THREADS * ITEMS  # SCAN_TILE: rows a block scans or compacts
# rows, ranks, offsets and the count are 32-bit on the card (the count is
# an int32 tensor); the row-index slot writes int32 row numbers
MAX_ROWS = (1 << 31) - 1
MAX_WORDS = 8  # payload words one launch 2 moves (MAX_WORDS in csrc/common.cuh)
WINDOW = 32  # predecessors one look-back step reads, a warp's lanes
COUNT_WORD = 1  # K3's scratch word that holds the count
SHARED_BYTES = 232448  # dynamic shared memory a block may use on the H100
EXPAND_THREADS = 256  # K14's block: warps 0 and 1 search, every thread merges
EXPAND_ITEMS = 15  # K14's merge items a thread (V; odd: no bank conflicts in the merge)


def tiles(n: int, tile: int = TILE) -> int:
    return -(-n // tile)


def tile_rows(t: int, n: int, reverse: bool, tile: int = TILE) -> range:
    """The rows of the t-th tile in scan order; tiles start at multiples of
    `tile`, so the last one in row order is the short one."""
    j = tiles(n, tile) - 1 - t if reverse else t
    return range(j * tile, min((j + 1) * tile, n))


def scan_scratch_words(n: int) -> int:
    """K2's scratch in 32-bit words: the tile counter, one word that brings
    the status words to an 8-byte boundary (where the base is only 4-byte
    aligned), and a 64-bit status word a tile.  A memset zeroes all of it."""
    return 2 + 2 * tiles(n)


def compact_scratch_words(n: int) -> int:
    """K3's scratch in 32-bit words: the done counter (zeroed by a memset of
    4 bytes), the count (``COUNT_WORD``), and one word a tile that launch 1
    fills with the tile's kept rows and its last block turns into exclusive
    offsets."""
    return 2 + tiles(n)


def check_rows(kernel: str, n: int) -> None:
    """Refuse a row count that the kernels' 32-bit rows cannot hold."""
    if n > MAX_ROWS:
        raise ValueError(
            f"{kernel}: {n} rows; K2 and K3 take at most 2^31 - 1, because rows, ranks "
            f"and the count are 32-bit on the card")


def check_row_index(kernel: str, base: int, n: int) -> None:
    """Refuse a row-index slot whose words ``base + i`` leave the int32 range."""
    if base < 0 or base + n > 1 << 31:
        raise ValueError(
            f"{kernel}: a row-index slot from {base} over {n} rows leaves [0, 2^31); "
            f"its words are int32 row numbers")


class ExpandPlan(NamedTuple):
    threads: int
    items: int  # merge items a thread
    blocks: int  # ceil((cap + nprobe) / (threads * items))
    shared_bytes: int  # the block's slice of c and its outputs, 4 bytes an item each


def expand_plan(cap: int, nprobe: int) -> ExpandPlan:
    """K14's plan for `cap` outputs and `nprobe` entries of c, from the
    ``EXPAND_*`` constants; merge positions run to cap + nprobe, past 2^31,
    so the grid is counted here in Python's integers.  Raises ValueError on
    what the kernel refuses."""
    if cap < 0 or nprobe < 0:
        raise ValueError(f"expand_sources: cap {cap} and {nprobe} probe rows must be >= 0")
    if max(cap, nprobe) > MAX_ROWS:
        raise ValueError(f"expand_sources: {max(cap, nprobe)} rows; rows are int32")
    threads, items = EXPAND_THREADS, EXPAND_ITEMS
    if threads < 64 or threads > 1024 or threads % LANES:
        raise ValueError(f"expand_sources: {threads} threads a block; the kernel takes whole "
                         f"warps, at least two (they search) and at most 1024")
    nv = threads * items
    if items < 1 or 8 * nv + 16 > SHARED_BYTES:  # and the two splits, 8 bytes each
        raise ValueError(f"expand_sources: {items} items a thread; a block stages its "
                         f"{nv} items twice in shared memory, at most {SHARED_BYTES} bytes")
    return ExpandPlan(threads, items, -(-(cap + nprobe) // nv), 8 * nv)
