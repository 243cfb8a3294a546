"""The pass schedule of the one-sweep LSD radix sort (``csrc/radix.cuh``)
that carries K1 (``radix_sort.py``) and K5 (``words_sort.py``).

A schedule is a tuple of passes, least significant digit first.  A pass is
``(word, shift, flag)``: its digit is ``(words[word] >> shift) & 0xFF``, with
the row's inactive flag above it as a ninth bit where ``flag`` is 1 (only
the last pass).  ``words`` are the key columns, most significant first.
The wrappers hand the schedule to the C entry; the CPU tests apply it by one
stable sort per digit and hold the result against the plain versions and
the JAX package.

A pass is trivial where every row has the same digit: one bucket of the
histogram holds all n rows.  The kernel reads that from its upfront
histogram on the card and skips the pass (where every pass is trivial, the
last one copies the input through); ``trivial_passes`` computes the same
decision from the inputs.

After the sort both kernels gather their extra words through the order
(``gather_words_*`` in ``csrc/radix.cuh``): packed (a coalesced pass
interleaves a group of 2-4 words into 8- or 16-byte rows in the sort's free
key buffers, then one vector load moves a row) where ``gather_packed`` says
so, else direct (a 4-byte load a word); a thread takes 4 rows, its order
entries and output runs by 16-byte accesses.
``tests/test_torch_gather_schedule.py`` emulates both forms.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Sequence

import torch

from ..batch import as_u32

DIGIT_BITS = 8
WORD_SHIFTS = (0, 8, 16, 24)
TILE = 4096  # rows a block ranks in one pass (RS_TILE in csrc/radix.cuh)
# the row index is 31 bits of the value a pass moves (bit 31 is the inactive
# flag): RS_MAX_ROWS, the JAX sorts' own limit (int32 positions)
MAX_ROWS = (1 << 31) - 1
# The look-back's status word, one a tile and digit (csrc/radix.cuh): 0 until
# the tile publishes, then its count of the digit plus one (at most TILE +
# 1), then STATUS_PREFIX | its inclusive prefix over the tiles before and
# itself (at most MAX_ROWS).
STATUS_PREFIX = 1 << 31  # RS_PREFIX
LOOKBACK = 16  # predecessor tiles read at once (RS_LOOKBACK)
MAX_WORDS = 40  # MAX_KEY_WORDS in csrc/common.cuh
KIND_TRIVIAL, KIND_SCATTERED = 1, 2  # RS_KIND_* in csrc/radix.cuh
# the gather of the extra words (csrc/radix.cuh)
GATHER_PACK_WORDS = 4  # words of a packed row at most (GW_PACK_WORDS: 16 bytes)
GATHER_DIRECT_WORDS = 8  # words of a direct launch at most (MAX_WORDS in csrc/common.cuh)
GATHER_PACK_BYTES = 4 << 20  # extras' bytes past which packing pays (tools/gather_sweep.py)

Pass = tuple[int, int, int]

_recording: list | None = None


def view_sort_schedule() -> tuple[Pass, ...]:
    """K1: the 33-bit (inact, key) composite in passes of 8, 8, 8 and 9 bits."""
    return words_sort_schedule(1, True)


def words_sort_schedule(m: int, with_inact: bool) -> tuple[Pass, ...]:
    """K5: four 8-bit passes a word, from the last word's low byte to the
    first word's high byte; with `with_inact` the last pass carries the
    inactive flag as its top bit."""
    if not 1 <= m <= MAX_WORDS:
        raise ValueError(f"radix sort: {m} key words; the kernel takes 1 to {MAX_WORDS}")
    passes = [(w, shift, 0) for w in reversed(range(m)) for shift in WORD_SHIFTS]
    if with_inact:
        passes[-1] = (0, WORD_SHIFTS[-1], 1)
    return tuple(passes)


def check_rows(kernel: str, n: int) -> None:
    """Refuse a row count that the sort's 32-bit row index cannot hold."""
    if n > MAX_ROWS:
        raise ValueError(
            f"{kernel}: {n} rows; the radix sort's row index is 32-bit (at most {MAX_ROWS}, "
            f"bit 31 carries the inactive flag)")


def gather_packed(n: int, nextra: int) -> bool:
    """The gather's form for n rows and `nextra` words: packed (groups of
    ``GATHER_PACK_WORDS`` interleaved first) where there are at least two
    words and their bytes pass ``GATHER_PACK_BYTES`` (one random sector a row
    instead of one a word; below it the launch that packs costs what it
    saves), else direct."""
    return nextra >= 2 and 4 * n * nextra > GATHER_PACK_BYTES


def gather_groups(nextra: int, packed: bool) -> list[tuple[int, int, int]]:
    """The launches' word groups: (first word, words, packed row width: 2 or
    4, 0 for direct), as ``gather_extras`` walks them."""
    step = GATHER_PACK_WORDS if packed else GATHER_DIRECT_WORDS
    out = []
    for first in range(0, nextra, step):
        cnt = min(step, nextra - first)
        out.append((first, cnt, 0 if not packed or cnt == 1 else 2 if cnt == 2 else 4))
    return out


def schedule_array(sched: Sequence[Pass]) -> ctypes.Array:
    """The schedule as the C entry reads it: (word, shift, flag) int32 triples."""
    flat = [x for p in sched for x in p]
    return (ctypes.c_int32 * len(flat))(*flat)


def pass_digits(words: Sequence[torch.Tensor], inact: torch.Tensor | None,
                p: Pass) -> torch.Tensor:
    """The digit of pass `p` for every row, in row order (int64)."""
    word, shift, flag = p
    d = (as_u32(words[word]) >> shift) & ((1 << DIGIT_BITS) - 1)
    if flag:
        d = d | (inact.long() << DIGIT_BITS)
    return d


def trivial_passes(words: Sequence[torch.Tensor], inact: torch.Tensor | None,
                   sched: Sequence[Pass]) -> list[bool]:
    """For each pass, whether one digit holds every row (no rows: all)."""
    out = []
    for p in sched:
        d = pass_digits(words, inact, p)
        out.append(bool(d.numel() == 0 or bool((d == d[0]).all())))
    return out


@contextlib.contextmanager
def record_pass_kinds():
    """Within the block the K1 and K5 wrappers append, for each launch, a
    device view of the kinds their passes took (KIND_TRIVIAL or
    KIND_SCATTERED); read it after a synchronize."""
    global _recording
    outer, _recording = _recording, []
    try:
        yield _recording
    finally:
        _recording = outer


def note_kinds(scratch: torch.Tensor, npasses: int) -> None:
    """Called by a wrapper after its launch: the first npasses words of its
    scratch hold the kinds of its passes."""
    if _recording is not None:
        _recording.append(scratch[:npasses])
