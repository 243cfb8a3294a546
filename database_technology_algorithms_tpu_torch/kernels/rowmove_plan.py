"""The launch plan of the row-move engine (``csrc/rowmove.cuh``) that carries
K4 (``take_fill.py``) and K12 (``row_move.py``).

A block owns a contiguous span of rows on the side that is read or written
in order (the output of a gather, the input of a scatter).  One thread a row
reads the row's index once; the wide rows then move as vectors of 1, 2 or 4
u32 words (4-, 8- or 16-byte accesses), consecutive threads on consecutive
vectors.  The plan is chosen here, where the CPU tests reach it, and handed
to the C entries, which check it again and dispatch on the vector width:

- ``access_words``: the widest vector that divides the row's width and the
  alignment of every base pointer.  Rows are views with offsets (a batch's
  slice, a chunk of an index), so alignment is read from ``data_ptr()``,
  never assumed.
- ``block_rows``: the rows a block owns, a power of two from 1 to
  ``MAX_BLOCK_ROWS``.  Where the rows the call touches fit in the card's L2
  cache, large spans (about ``L2_VECTORS`` vectors) share the index phase
  and its barrier among more vectors; beyond it, small spans (about
  ``DRAM_VECTORS``) keep the blocks in flight on nearby rows.
  ``tools/rowmove_sweep.py`` times every span at the main paths' shapes on
  the card (PERF.md has its readings).
- ``count_arg``: an optional live count (positions at or past it are fill
  rows) as a device pointer or a host integer.
"""

from __future__ import annotations

import torch

VEC_WORDS = (4, 2, 1)  # 16-, 8- and 4-byte accesses, widest first
MAX_BLOCK_ROWS = 1024  # rowmove::MAX_ROWS in csrc/rowmove.cuh
L2_BYTES = 50 * 10**6  # the H100's L2 cache
L2_VECTORS = 8192  # vectors a block moves where the call fits in L2
DRAM_VECTORS = 1024  # and where it does not
MIN_DRAM_ROWS = 64
# a block-local vector number e is split into (row, vector) by a 32-bit
# multiply-high, exact while e * vectors_per_row < 2^32
MAX_ROW_VECTORS = (1 << 16) - 1
MAX_ROWS = (1 << 31) - 1  # rows and positions are addressed in 32 bits


def access_words(width: int, *ptrs: int) -> int:
    """The widest access, in u32 words (4, 2 or 1), that divides a row of
    `width` words and the byte alignment of every pointer in `ptrs`."""
    for v in VEC_WORDS:
        if width % v == 0 and all(p % (4 * v) == 0 for p in ptrs):
            return v
    raise ValueError(f"row move: pointers {ptrs} are not aligned to 4 bytes")


def block_rows(row_vectors: int, footprint_bytes: int) -> int:
    """Rows a block owns for rows of `row_vectors` vectors in a call that
    touches `footprint_bytes` (source and destination rows): the largest
    power of two with at most L2_VECTORS (within L2) or DRAM_VECTORS (beyond
    it, at least MIN_DRAM_ROWS) vectors, within [1, MAX_BLOCK_ROWS]."""
    in_l2 = footprint_bytes <= L2_BYTES
    vectors = L2_VECTORS if in_l2 else DRAM_VECTORS
    least = 1 if in_l2 else MIN_DRAM_ROWS
    rows = MAX_BLOCK_ROWS
    while rows > least and rows * row_vectors > vectors:
        rows //= 2
    # the split of a block's vectors stays exact (rowmove.cuh: e * d < 2^32)
    while rows > 1 and rows * row_vectors * row_vectors >= 1 << 32:
        rows //= 2
    return rows


def check_shape(kernel: str, rows: int, positions: int, row_vectors: int) -> None:
    """Refuse what the engine's 32-bit addressing cannot take."""
    if max(rows, positions) > MAX_ROWS:
        raise ValueError(f"{kernel}: {max(rows, positions)} rows; the row-move engine "
                         f"addresses at most 2^31 - 1 in 32 bits")
    if row_vectors > MAX_ROW_VECTORS:
        raise ValueError(f"{kernel}: rows of {row_vectors} vectors; the row-move engine "
                         f"splits a block's vectors by a 32-bit multiply-high, exact up to "
                         f"{MAX_ROW_VECTORS}")


def count_arg(count, positions: int, device) -> tuple[torch.Tensor | None, int]:
    """The live count as the C entries take it: (a 0-d int32 tensor on
    `device` whose pointer is passed, or None; the host count used where the
    pointer is null).  None means every position is live; a host integer is
    clamped to [0, positions]."""
    if count is None:
        return None, positions
    if isinstance(count, torch.Tensor):
        if count.numel() != 1:
            raise ValueError(f"row move: count must hold one value, got shape {tuple(count.shape)}")
        return count.reshape(()).to(device=device, dtype=torch.int32), positions
    return None, min(max(int(count), 0), positions)


def live_positions(positions: int, count, device) -> torch.Tensor:
    """The plain versions' form of the count: a mask of positions below it."""
    return torch.arange(positions, device=device) < count
