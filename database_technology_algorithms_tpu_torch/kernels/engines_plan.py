"""The launch plan and refusals of the alternative u32 engines' kernels: K15,
the sorted-key probe (``csrc/sorted_probe.cu``), K16 and K17, the
open-addressing hash set (``csrc/hash_set.cu``), and K18, the bucket compare
(``csrc/bucket_probe.cu``).

- K15 and K17 run one thread a probe row, K16 one a build key.
- K16 inserts a key into at most ``insert_limit(max_probe)`` slots, the
  bound under which K17 finds every stored key; a key that passes it fails.
- K18 runs one warp a bucket and holds a bucket's build keys in the warp's
  slice of ``BUCKET_MAX_CAP`` words of shared memory, so a bucket's
  capacity may not exceed it.

The C entries repeat these checks; ``tests/test_torch_engines_schedule.py``
emulates the three kernels with them on the CPU.
"""

from __future__ import annotations

MAX_ROWS = (1 << 31) - 1  # rows and positions are 32-bit on the card
INSERT_MAX_PROBE = 64  # the most slots K16 tries for one key (the JAX build's max_iters)
MAX_TABLE_SLOTS = 1 << 31  # K16's slots are u32 hashes masked by size - 1
BUCKET_MAX_CAP = 128  # MAX_CAP in csrc/bucket_probe.cu


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
        raise ValueError(f"{name}: {nbuckets} buckets; one warp a bucket, at most {MAX_ROWS - 1}")
    if not 0 <= cap <= BUCKET_MAX_CAP:
        raise ValueError(f"{name}: capacity {cap}; a warp holds at most {BUCKET_MAX_CAP} build "
                         f"keys of a bucket")
