"""The launch plans and refusals of the alternative u32 engines' kernels: K15,
the sorted-key probe (``csrc/sorted_probe.cu``), K16 and K17, the
open-addressing hash set (``csrc/hash_set.cu``), and K18, the bucket compare
(``csrc/bucket_probe.cu``).

- K15 (``probe_plan``): an index of every S-th live build key, laid out as a
  perfect binary search tree in breadth-first order (``2^levels - 1`` keys,
  padded with ``U32_MAX``), is written by one small launch and copied into
  the shared memory of each block of a persistent grid; a probe row walks
  the tree, then searches the at most S - 1 keys between two index keys in
  device memory.  S is the least stride for which the live count's index
  fits the tree (``probe_stride``); the count may lie on the card, so the
  kernels derive S themselves.
- K16 (``hash_plan``): after one fill launch (the table to EMPTY), a
  thread takes ``HASH_KEYS`` keys (at 4 and 8 by 16-byte loads where the
  keys are contiguous and aligned, the tail and other layouts key by key),
  issues their home trips together, then their compare-and-swaps together,
  and reads a taken slot's successors ``HASH_WINDOW`` slots (one aligned
  16-byte window) a trip.  The plan is the one ``tools/hash_sweep.py``
  chose: one key a thread, a window of 4.  It inserts a key into at most
  ``insert_limit(max_probe)`` slots, the bound under which K17, one thread a
  key, finds every stored key; a key that passes it fails.
- K18 (``bucket_plan``): one launch writes the first row of every bucket
  on both sides (``bucket_starts_words``), the next gives a block a span of
  ``span`` consecutive buckets, whose build keys it holds in shared memory,
  so a bucket's capacity may not exceed ``BUCKET_MAX_CAP``.

The C entries repeat these checks; ``tests/test_torch_engines_schedule.py``
emulates the kernels with them on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

MAX_ROWS = (1 << 31) - 1  # rows and positions are 32-bit on the card
INSERT_MAX_PROBE = 64  # the most slots K16 tries for one key (the JAX build's max_iters)
MAX_TABLE_SLOTS = 1 << 31  # K16's slots are u32 hashes masked by size - 1
BUCKET_MAX_CAP = 128  # MAX_CAP in csrc/bucket_probe.cu

PROBE_LEVELS = 15  # K15's index: a tree of at most 2^15 - 1 keys, 128 KiB a block
PROBE_MAX_LEVELS = 15  # MAX_LEVELS in csrc/sorted_probe.cu: 2^15 words, 128 KiB
PROBE_THREADS = 512  # a block of K15's search
PROBE_BLOCKS_PER_SM = 1  # at most: more blocks leave less of the SM's memory to L1
SM_SHARED_BYTES = 233472  # an SM's shared memory
BLOCK_RESERVED_BYTES = 1024  # what the card reserves of it a block
SM_THREADS = 2048
H100_SMS = 132

HASH_KEYS = 1  # K16's keys a thread: 1, 2, 4 or 8 (4 and 8 read by 16-byte loads)
HASH_THREADS = 256  # K16's insert block
HASH_WINDOW = 4  # K16's slots a read: 1, or 4 (one 16-byte window)

BUCKET_SPAN = 32  # buckets a block of K18's compare
BUCKET_MAX_SPAN = 32  # MAX_SPAN in csrc/bucket_probe.cu: a warp scans the span's counts
BUCKET_THREADS = 128  # a block of K18's compare


def check_rows(name: str, *sizes: int) -> None:
    for n in sizes:
        if n > MAX_ROWS:
            raise ValueError(f"{name}: {n} rows; the kernel's rows are int32 (at most {MAX_ROWS})")


def insert_limit(max_probe: int) -> int:
    """The slots K16 tries for a key before counting it as failed: at most
    the probe's ``max_probe``, so that K17 finds every key that was stored."""
    return max(min(INSERT_MAX_PROBE, int(max_probe)), 0)


def check_table(name: str, size: int) -> None:
    if size < 1 or size & (size - 1) or size > MAX_TABLE_SLOTS:
        raise ValueError(f"{name}: {size} slots; a table is a power of two of at most "
                         f"{MAX_TABLE_SLOTS} slots")


def check_buckets(name: str, nbuckets: int, cap: int) -> None:
    if not 1 <= nbuckets < MAX_ROWS:
        raise ValueError(f"{name}: {nbuckets} buckets; bucket ids are int32, at most "
                         f"{MAX_ROWS - 1} buckets")
    if not 0 <= cap <= BUCKET_MAX_CAP:
        raise ValueError(f"{name}: capacity {cap}; a block holds at most {BUCKET_MAX_CAP} build "
                         f"keys of a bucket")


class ProbePlan(NamedTuple):
    levels: int  # the index tree's levels: 2^levels - 1 keys, 4 << levels bytes a block
    threads: int
    blocks_per_sm: int


def probe_plan(nb: int) -> ProbePlan:
    """K15's plan for a build column of `nb` rows, from ``PROBE_LEVELS``,
    ``PROBE_THREADS`` and ``PROBE_BLOCKS_PER_SM``: the tree
    has no more levels than `nb` keys need (at least one), the blocks an SM
    are those whose trees and threads fit one together.  Raises ValueError
    on what the kernel refuses."""
    check_rows("sorted_probe", nb)
    levels = max(min(PROBE_LEVELS, int(nb).bit_length()), 1)
    threads = PROBE_THREADS
    if not 1 <= levels <= PROBE_MAX_LEVELS:
        raise ValueError(f"sorted_probe: an index of {levels} levels; the kernel takes "
                         f"1-{PROBE_MAX_LEVELS}")
    if threads < 32 or threads > 1024 or threads % 32:
        raise ValueError(f"sorted_probe: {threads} threads a block; the kernel takes whole "
                         f"warps, at most 1024")
    bps = min(PROBE_BLOCKS_PER_SM, SM_SHARED_BYTES // ((4 << levels) + BLOCK_RESERVED_BYTES),
              SM_THREADS // threads)
    if bps < 1:
        raise ValueError(f"sorted_probe: {PROBE_BLOCKS_PER_SM} blocks an SM")
    return ProbePlan(levels, threads, bps)


def probe_stride(count: int, levels: int) -> tuple[int, int]:
    """(S, entries) as K15's kernels derive them from the live count: S =
    ``ceil(count / (2^levels - 1))`` (at least 1), so that the
    ``ceil(count / S)`` index keys (rows 0, S, 2S, ...) fit the tree."""
    stride = max(-(-count // ((1 << levels) - 1)), 1)
    return stride, -(-count // stride)


def tree_rank(j: int, levels: int) -> int:
    """The rank in the sorted index of the tree's slot j (1-based,
    breadth-first; slot j's children are 2j and 2j + 1)."""
    d = j.bit_length() - 1
    return ((2 * (j - (1 << d)) + 1) << (levels - 1 - d)) - 1


def probe_grid(npr: int, plan: ProbePlan, sms: int = H100_SMS) -> int:
    """The search launch's blocks: blocks_per_sm an SM, at most one a
    block's probe rows."""
    return max(min(plan.blocks_per_sm * sms, -(-npr // plan.threads)), 1)


class HashPlan(NamedTuple):
    keys: int  # keys a thread
    threads: int
    window: int  # slots a read
    vec: bool  # the keys read `keys` a load
    blocks: int  # the insert's grid: it covers the keys once


def hash_plan(n: int, size: int, keys_ptr: int) -> HashPlan:
    """K16's plan for n keys into `size` slots, from the ``HASH_*``
    constants: the vector path takes the keys aligned to ``4 * keys`` bytes
    (16 at most), a window of 4 slots a table of at least 4.  Raises
    ValueError on what the kernel refuses."""
    keys, threads, window = HASH_KEYS, HASH_THREADS, HASH_WINDOW
    if keys not in (1, 2, 4, 8):
        raise ValueError(f"hash_set_build: {keys} keys a thread; the kernel takes 1, 2, 4 or 8")
    if threads < 32 or threads > 1024 or threads % 32:
        raise ValueError(f"hash_set_build: {threads} threads a block; the kernel takes whole "
                         f"warps, at most 1024")
    if window not in (1, 4):
        raise ValueError(f"hash_set_build: a window of {window} slots; the kernel takes 1 or 4")
    window = window if size >= window else 1
    vec = keys_ptr % min(4 * keys, 16) == 0
    return HashPlan(keys, threads, window, vec, max(-(-n // (threads * keys)), 1))


class BucketPlan(NamedTuple):
    span: int  # consecutive buckets a compare block, whose build keys it holds
    threads: int


def bucket_plan() -> BucketPlan:
    """K18's compare plan from ``BUCKET_SPAN`` and ``BUCKET_THREADS``: a
    block holds at most span * cap build keys."""
    span, threads = BUCKET_SPAN, BUCKET_THREADS
    if not 1 <= span <= BUCKET_MAX_SPAN:
        raise ValueError(f"bucket_probe: a span of {span} buckets; the kernel takes "
                         f"1-{BUCKET_MAX_SPAN}")
    if threads < 32 or threads > 1024 or threads % 32:
        raise ValueError(f"bucket_probe: {threads} threads a block; the kernel takes whole "
                         f"warps, at most 1024")
    return BucketPlan(span, threads)


def bucket_starts_words(nbuckets: int) -> int:
    """The starts scratch: the first row of buckets 0..nbuckets + 1 of the
    build side, then of the probe side."""
    return 2 * (nbuckets + 2)
