"""The launch plan of K9, staging into cells (``csrc/stage_cells.cu``,
``stage_cells.py``), and of K10, the build multiplicity over cell pairs
(``csrc/member_mult.cu``, ``member_mult.py``).

K9 is a stable partition into ``nparts + 1`` buckets (the sink ``nparts``
takes inactive rows, rows at or past the live count and destinations at or
above ``nparts``), computed without a sort:

- count: a block owns ``SPAN`` rows, histograms their buckets in shared
  memory (warp-aggregated atomics) and writes its column of the
  bucket-major matrix ``[nbins, nspans]``; rows past the live count are
  added to the sink unread;
- scan: K2's engine (``csrc/scan.cuh``) scans the matrix in place, so entry
  (b, s) holds the rows of the buckets below b plus those of bucket b in
  spans up to s: the last row of (b, s) in "si" order, plus one;
- finish: each bucket's start, the counts clamped to ``cap``, the overflow
  and the sink's size, on the card;
- fill: a block a chunk of 2048 slots of one cell writes the fill value (0
  unless given) into the chunk's dead slots, ``[counts[c], cap)`` of its
  cell;
- place: a block owns its span again, ``warps`` warps each a contiguous
  sub-span of ``SPAN / warps`` rows.  Each warp counts its sub-span's
  buckets into its own 16-bit counters in shared memory; the block turns
  them into each warp's first place a bucket; each warp then walks its
  sub-span in row order, 32 rows a step, and a row's place is its warp's
  counter plus its rank among the step's earlier lanes of its bucket
  (``__match_any_sync``).  No block barrier inside the walk.

K10 gives each cell pair an open-addressing table of ``table_slots(live)``
slots, sized on the card from the pair's live build rows, in shared memory
when it fits the launch's ``shared`` slots and in global scratch otherwise.
A slot is probed from the key's murmur3 hash at triangular steps (1, 2, 3,
... slots on).  A one-word key's slot is (count, key), so every compare
stays in shared memory; a wider key's slot is (32-bit hash, build row)
beside a count, and the build row's words are read only on a hash match.

The wrappers hand these numbers to the C entries, which refuse a plan that
differs from their own checks; ``tests/test_torch_cells_schedule.py``
emulates both kernels with them on the CPU.
"""

from __future__ import annotations

import numpy as np

from .scan_plan import scan_scratch_words

SHARED_BYTES = 232448  # dynamic shared memory a block may use on the H100
LANES = 32  # a warp
# K9
SPAN = 16384  # rows a count or place block owns (ST_MAX_SPAN in csrc/stage_cells.cu)
MAX_SPAN = 65535  # a warp's 16-bit counters hold up to a span's rows
PLACE_WARPS = 8  # the most; fewer where the bins' counters would not fit
OWN_BYTES = 2048  # bytes a place warp marks its step's single lanes in (ST_OWN)
MAX_ROWS = (1 << 31) - 1  # rows, places and slots are 32-bit on the card
# K10
TABLE_THREADS = 1024
TABLE_MIN_SLOTS = 64
TABLE_BYTES = 64 * 1024  # shared memory a pair's table may take
MAX_TABLE_BUILD = (1 << 30) - 1  # build rows of a pair (4/3 of them must fit 31 bits)


def spans(n: int, span: int = SPAN) -> int:
    return max(-(-n // span), 1)


def count_bytes(nbins: int) -> int:
    """Shared memory of the count kernel: a 32-bit counter a bin."""
    return 4 * nbins


def place_bytes(nbins: int, warps: int) -> int:
    """Shared memory of the place kernel: each bin's first place (32 bits),
    every warp's 16-bit counters (each warp's run of them padded to 4 bytes)
    and every warp's ``OWN_BYTES`` marks."""
    return 4 * nbins + warps * (2 * (nbins + (nbins & 1)) + OWN_BYTES)


def place_warps(nbins: int, span: int = SPAN, most: int | None = None) -> int:
    """The most warps (`most`, default ``PLACE_WARPS``, then halved) whose
    counters fit shared memory and split the span into whole steps of 32
    rows; 0 if none fits."""
    w = PLACE_WARPS if most is None else most
    while w >= 1:
        if place_bytes(nbins, w) <= SHARED_BYTES and span % (LANES * w) == 0:
            return w
        w //= 2
    return 0


# the most bins with place_bytes(nbins, 1) <= SHARED_BYTES (an even count
# needs no padding)
MAX_STAGE_BINS = (SHARED_BYTES - OWN_BYTES) // 6 // 2 * 2
MAX_BOUNDARY_BINS = SHARED_BYTES // 4


def check_stage(kernel: str, n: int, nparts: int, cap: int, span: int = SPAN) -> int:
    """Refuse a staging that K9 cannot take; return the place kernel's warps."""
    nbins = nparts + 1
    if n > MAX_ROWS:
        raise ValueError(f"{kernel}: {n} rows; K9's rows and places are 32-bit (at most 2^31 - 1)")
    if nparts * cap > MAX_ROWS:
        raise ValueError(f"{kernel}: {nparts} cells of {cap} slots pass 2^31 - 1 slots, "
                         f"which K9 addresses in 32 bits")
    if nbins * spans(n, span) > MAX_ROWS:
        raise ValueError(f"{kernel}: the count matrix of {nbins} bins by {spans(n, span)} "
                         f"spans passes the 2^31 - 1 entries K2's scan takes")
    warps = place_warps(nbins, span, PLACE_WARPS)
    if not warps:
        raise ValueError(
            f"{kernel}: {nparts} cells; K9's place pass keeps a span's {nbins} bucket counters "
            f"in shared memory, 6 bytes a bucket and {OWN_BYTES} more for one warp, and "
            f"{SHARED_BYTES} bytes hold at most {MAX_STAGE_BINS - 1} cells (the tiled join "
            f"needs 16384 near 100M + 100M rows)")
    return warps


def check_boundaries(kernel: str, n: int, nprobes: int, span: int = SPAN) -> None:
    nbins = nprobes + 1
    if n > MAX_ROWS:
        raise ValueError(f"{kernel}: {n} rows; K9's rows are 32-bit (at most 2^31 - 1)")
    if count_bytes(nbins) > SHARED_BYTES:
        raise ValueError(
            f"{kernel}: {nprobes} probes; K9 counts a span's {nbins} bins in shared memory, "
            f"4 bytes a bin, and {SHARED_BYTES} bytes hold at most {MAX_BOUNDARY_BINS - 1} probes")
    if nbins * spans(n, span) > MAX_ROWS:
        raise ValueError(f"{kernel}: the count matrix of {nbins} bins by {spans(n, span)} "
                         f"spans passes the 2^31 - 1 entries K2's scan takes")


def stage_scratch_words(n: int, nparts: int, span: int = SPAN) -> int:
    """K9's scratch in 32-bit words: the count matrix, K2's scratch for its
    scan, and each bucket's start."""
    nbins = nparts + 1
    entries = nbins * spans(n, span)
    return entries + scan_scratch_words(entries) + nbins


def boundary_scratch_words(n: int, nprobes: int, span: int = SPAN) -> int:
    """value_boundaries' scratch: the count matrix and K2's scratch."""
    entries = (nprobes + 1) * spans(n, span)
    return entries + scan_scratch_words(entries)


# ---------------------------------------------------------------------------
# K10


def table_slots(live: int) -> int:
    """Slots of a pair's table: the next power of two of 4/3 of its live
    build rows, at least ``TABLE_MIN_SLOTS``, so at least a quarter stay
    empty and every probe ends."""
    want = (4 * max(live, 0) + 2) // 3
    s = TABLE_MIN_SLOTS
    while s < want:
        s *= 2
    return s


def slot_bytes(m: int) -> int:
    """A slot of a one-word key: (count, key) in 8 bytes; of a wider key:
    (fingerprint, build row + 1) in 8 bytes and a 4-byte count."""
    return 8 if m == 1 else 12


def table_cap(cap_b: int, m: int, budget: int = TABLE_BYTES) -> int:
    """The shared table's slots for a launch over pairs of `cap_b` build
    rows: ``table_slots(cap_b)`` (every pair fits) where that fits `budget`
    bytes, else the most slots a power of two that do; pairs whose live rows
    need more take the global table."""
    s = table_slots(cap_b)
    while s > TABLE_MIN_SLOTS and s * slot_bytes(m) > budget:
        s //= 2
    return s


def table_scratch_words(pairs: int, cap_b: int, m: int, shared: int) -> int:
    """Words of the global tables: one of ``table_slots(cap_b)`` slots a
    pair, or none where every pair fits the shared table."""
    full = table_slots(cap_b)
    if full <= shared:
        return 0
    return pairs * full * slot_bytes(m) // 4


def check_table(kernel: str, cap_b: int) -> None:
    if cap_b > MAX_TABLE_BUILD:
        raise ValueError(f"{kernel}: {cap_b} build rows a pair; K10's table holds at most "
                         f"{MAX_TABLE_BUILD}")


def table_hash(keys: np.ndarray) -> np.ndarray:
    """K10's table hash (murmur3 over the key words) of each row of `keys`
    (u32 [rows, m]), as csrc/member_mult.cu computes it: the CPU emulation
    and the card's check of two keys with one hash use it."""
    u = np.uint32

    def rotl(x, r):
        return (x << u(r)) | (x >> u(32 - r))

    h = np.full(keys.shape[0], 0x9747B28C, u)
    for j in range(keys.shape[1]):
        w = keys[:, j].astype(u) * u(0xCC9E2D51)
        w = rotl(w, 15) * u(0x1B873593)
        h = rotl(h ^ w, 13) * u(5) + u(0xE6546B64)
    h ^= h >> u(16)
    h *= u(0x85EBCA6B)
    h ^= h >> u(13)
    h *= u(0xC2B2AE35)
    return h ^ (h >> u(16))
