"""Open-addressing hash set of u32 keys: build once, probe by hash.

Port of the JAX package's ``ops/hash_table.py``.  The reference's hash join
builds an STL ``unordered_map`` per query (``DatabaseProject.cpp:510-548``);
here a power-of-two slot array on the card is filled by parallel insertion
(K16: one ``atomicCAS`` a slot, linear probing) and probed by hash, read
and compare (K17).  The table's size follows the build rows and the
configured load factor, so its memory is bounded and explicit.

The port is exact where the JAX form is not (see ``csrc/hash_set.cu``): the
one key whose mix is ``EMPTY`` is flagged, never stored under another key's
mix, and the build gives up on a key after ``min(64, cfg.hash_max_probe)``
slots, so a key the probe could miss sends the call to the exact fallback
(``hash_join_count_u32``) instead.
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch, as_u32, u32_bits
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels import engines_plan
from ..kernels.hash_set import HashSet, hash_set_build, hash_set_probe, mix_u32
from .fastpath import hash_join_count_u32, u32_key


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche u32 -> u32 (bijective), on int32
    words holding u32 bits."""
    return u32_bits(mix_u32(as_u32(h)))


def table_size_for(n_build: int, cfg: EngineConfig = DEFAULT_CONFIG) -> int:
    want = max(int(n_build) * cfg.hash_load_factor_inv, 16)
    return 1 << max(int(want - 1).bit_length(), 4)


def build_hash_set(
    keys: torch.Tensor,
    size: int,
    count=None,
    max_iters: int = engines_plan.INSERT_MAX_PROBE,
) -> tuple[HashSet, torch.Tensor]:
    """Insert keys (first `count` live) into a size-slot table (K16).

    Returns (set, n_failed): n_failed > 0 means some keys found no slot
    within `max_iters` (pathological clustering) and were not stored;
    callers must fall back.  Keys equal to one already stored are
    duplicates of it (semi-join set semantics)."""
    hs = hash_set_build(keys, size, count, max(int(max_iters), 0))
    return hs, hs.n_failed


def probe_hash_set(hs: HashSet, keys: torch.Tensor, count=None, max_probe: int = 64
                   ) -> torch.Tensor:
    """bool[N]: key present in the set (first `count` rows live), K17."""
    return hash_set_probe(hs, keys, count, max_probe)[0]


def hash_join_count_table(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    build_count=None,
    probe_count=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hash_join_count contract via the open-addressing table (u32 fields).
    The failure count is read on the host once; past the insertion bound the
    exact searchsorted path answers."""
    bkey = u32_key(build, field)
    size = table_size_for(build.nrows, cfg)
    hs, n_failed = build_hash_set(bkey, size, count=build_count,
                                  max_iters=engines_plan.insert_limit(cfg.hash_max_probe))
    if int(n_failed) > 0:
        return hash_join_count_u32(build, probe, field, build_count=build_count,
                                   probe_count=probe_count)
    hit, mult = hash_set_probe(hs, u32_key(probe, field), probe_count, cfg.hash_max_probe)
    return hit, mult, mult.sum(dtype=torch.int32)
