"""The launch plans of K6, adjacent-key equality (``csrc/adj_equal.cu``,
``adj_equal.py``), and of the gather form of K7, the un-permute
(``csrc/unpermute.cu``, ``unpermute.py``).

K6: a warp owns ``32 * R`` consecutive sorted rows, warp-striped: lane L
holds rows L, L + 32, ... of them, so that each of a warp's loads of perm,
of rows in place and of its stores is one coalesced run.  A lane loads its
``R`` perm entries, then its rows' key words, and only then compares.  The
predecessor of a row is the lane below's row of the same step, passed by a
shuffle; lane 0's is lane 31's row of the step before, and lane 0 reads the
one predecessor that lies before the warp.  So each sorted row's key is
read once.  The key is compared in stages (``key_stages``): a stage is up
to ``CHUNK_WORDS`` words that lie together in a row, loaded together with
no compare between them; between stages a row stops where its key already
differs, and loads a later stage only while its own compare or its
successor's is open.

The key words are read as vectors where they lie together: ``key_runs``
groups the words into runs of adjacent columns (word k + 1 four bytes past
word k, one row stride), and ``word_widths`` cuts each stage into 16-, 8-
and 4-byte pieces by its length and the alignment of its pointer and
stride, which the kernel takes as one pattern a stage
(``stage_patterns``).  ``strw[:, j]`` for consecutive j is such a run; a
view that starts at an odd column reads 4 bytes at a time.

K7's gather (``out[i] = vals[first[s / cap] + s % cap]`` for ``s =
slot_of_row[i]``) gives a thread ``R`` consecutive rows whose slots it
loads as 16-byte vectors with no condition ahead of them, in a grid of a
few waves of ``BLOCKS_PER_SM`` blocks an SM, which walk the rows
(``blocks``); it divides by ``cap`` with a multiplier from ``div_magic``.
K7's scatter has no plan: one thread a row, the grid covering the rows.

The wrappers hand these numbers to the C entries, which dispatch on them and
refuse what they were not built for; ``tests/test_torch_perm_schedule.py``
emulates the kernels with them on the CPU.  ``tools/perm_sweep.py`` times
every ``R`` and vector width on the card (``PERF.md`` has the readings).
"""

from __future__ import annotations

import functools

import torch

THREADS = 256  # threads a block of every K6 and K7 kernel
LANES = 32  # a warp
CHUNK_WORDS = 4  # the most key words of one K6 stage
MAX_KEY_WORDS = 40  # dbt::MAX_KEY_WORDS: num and the string words, with room
MAX_ROWS = (1 << 31) - 1  # rows, perm entries and slots are 32-bit on the card
VEC_WORDS = (4, 2, 1)  # 16-, 8- and 4-byte accesses, widest first

# R, rows a lane of K6 (ADJ_R in csrc/adj_equal.cu) and rows a thread of
# K7's gather (UP_GATHER_R in csrc/unpermute.cu; above 1 a multiple of the 4
# slots of a 16-byte vector); and the gather's grid: GATHER_WAVES times the
# blocks the card holds at once (BLOCKS_PER_SM an SM), which walk the rows.
# tools/perm_sweep.py builds the kernels with every R of the *_CHOICES and
# times them and the grids; PERF.md has the readings that chose these.
ADJ_ROWS = 2
ADJ_ROW_CHOICES = (1, 2, 4, 8)
GATHER_ROWS = 4
GATHER_ROW_CHOICES = (1, 4, 8)
GATHER_WAVES = 2
BLOCKS_PER_SM = 8  # 2048 resident threads an SM in blocks of THREADS


# ---------------------------------------------------------------------------
# K6


def key_runs(ptrs, strides) -> list[tuple[int, int]]:
    """(first word, length) of each run of adjacent key words: word k + 1
    lies four bytes past word k with the same row stride, so both are read
    from one row with one access.  `ptrs` are byte addresses, `strides` row
    strides in words."""
    runs, k, m = [], 0, len(ptrs)
    while k < m:
        end = k + 1
        while end < m and strides[end] == strides[k] and ptrs[end] == ptrs[end - 1] + 4:
            end += 1
        runs.append((k, end - k))
        k = end
    return runs


def key_stages(ptrs, strides) -> list[int]:
    """The first word of each stage of the key and, last, its word count: a
    stage is a run's next ``CHUNK_WORDS`` words (or fewer), so the words of
    one stage lie together in a row and load together, and a row compares
    stage by stage, stopping at the first that differs.  A key whose words
    lie apart (field 3's ``num`` beside ``strw``) so reads its second
    sector only where its first words tie."""
    starts = [first + off for first, length in key_runs(ptrs, strides)
              for off in range(0, length, CHUNK_WORDS)]
    return starts + [len(ptrs)]


def word_widths(ptrs, strides, stages=None) -> list[int]:
    """Per key word, the width in words of the vector that starts at it (4,
    2 or 1), or 0 for a word that an earlier vector reads.  Each stage
    (``key_stages``, or `stages`) is cut from its start into the widest
    pieces that fit its rest, whose words lie together and whose every row's
    address is aligned to the piece (pointer and row stride)."""
    stages = key_stages(ptrs, strides) if stages is None else stages
    widths = [0] * len(ptrs)
    for first, end in zip(stages[:-1], stages[1:]):
        k = first
        while k < end:
            for v in VEC_WORDS:
                if (k + v <= end and ptrs[k] % (4 * v) == 0 and strides[k] % v == 0
                        and all(ptrs[k + i] == ptrs[k] + 4 * i and strides[k + i] == strides[k]
                                for i in range(v))):
                    break
            widths[k] = v
            k += v
    return widths


def stage_patterns(widths, stages) -> list[int]:
    """Each stage's vectors as the kernel takes them: hex digits of the
    vector widths, the first lowest (``[1, 2, 0]`` is 0x21)."""
    out = []
    for first, end in zip(stages[:-1], stages[1:]):
        pattern = 0
        for q, v in enumerate(v for v in widths[first:end] if v):
            pattern |= v << (4 * q)
        out.append(pattern)
    return out


def key_plan(words) -> tuple[list[int], list[int]]:
    """(patterns, stages) of int32 column tensors, as the C entry takes them."""
    ptrs, strides = [w.data_ptr() for w in words], [w.stride(0) for w in words]
    stages = key_stages(ptrs, strides)
    return stage_patterns(word_widths(ptrs, strides, stages), stages), stages


def check_adj(kernel: str, n: int, m: int) -> None:
    """Refuse what K6 was not built for."""
    if not 1 <= m <= MAX_KEY_WORDS:
        raise ValueError(f"{kernel}: {m} key words, at most {MAX_KEY_WORDS}")
    if n > MAX_ROWS:
        raise ValueError(f"{kernel}: {n} rows; K6 addresses at most 2^31 - 1 in 32 bits")


def vector_ok(*ptrs: int) -> bool:
    """Every pointer 16-byte aligned, so a thread's rows load as vectors."""
    return all(p % 16 == 0 for p in ptrs)


# ---------------------------------------------------------------------------
# K7


def check_rows(kernel: str, n: int) -> None:
    if n > MAX_ROWS:
        raise ValueError(f"{kernel}: {n} rows; K7 addresses at most 2^31 - 1 in 32 bits")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def blocks(n: int, rows: int, waves: int, device=None, sms: int | None = None) -> int:
    """Blocks of a K7 gather for `n` rows at `rows` a thread: one block a
    THREADS * rows rows, at most `waves` times BLOCKS_PER_SM a streaming
    multiprocessor of the card (`sms`, or the count of `device`), whose
    blocks then walk the rest; `waves` 0 sets no limit."""
    need = max(-(-n // (THREADS * rows)), 1)
    if not waves:
        return need
    if sms is None:
        sms = _sms(torch.device(device).index or 0)
    return min(need, waves * sms * BLOCKS_PER_SM)


def div_magic(d: int) -> tuple[int, int]:
    """(mult, shift) with ``(s * mult) >> shift == s // d`` for every
    ``0 <= s < 2^31`` and ``1 <= d < 2^31`` (Granlund and Montgomery 1994:
    ``shift = 31 + ceil(log2 d)``, ``mult = ceil(2^shift / d) < 2^33``), so
    the product of a 31-bit slot fits 64 bits."""
    if not 1 <= d <= MAX_ROWS:
        raise ValueError(f"div_magic: divisor {d} outside [1, 2^31 - 1]")
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def check_gather(kernel: str, n: int, nparts: int, cap: int, nvals: int) -> None:
    check_rows(kernel, n)
    if nparts < 1 or cap < 1:
        raise ValueError(f"{kernel}: nparts and cap must be positive")
    if nparts * cap > MAX_ROWS or nvals > MAX_ROWS:
        raise ValueError(f"{kernel}: {nparts} cells of {cap} slots and {nvals} values; slots "
                         f"are 32-bit on the card")
