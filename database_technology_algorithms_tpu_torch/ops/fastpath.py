"""u32-key fast paths: single-word keys (recid / num) skip payload movement.

Port of the JAX package's ``ops/fastpath.py``.  For the single-word integer
key domains ('0' recid, '1' num) the semantics of the generic operators
need only key-width traffic:

* distinct: K1 sorts (inactive, key, row) with no payload, the survivors are
  the first live row of each key run, K3 compacts their rows and one record
  gather (K4, with the survivor count as its live count) emits them.
* hash join: K1 sorts the live build keys, the dead tail becomes
  ``U32_MAX`` so that the whole array is monotone, and K15 binary-searches
  every probe key in the live prefix (``cfg.u32_join_engine =
  "searchsorted"``).

Both keep the static-capacity + live-count convention and are exact:
padding sinks by the inactive flag, never by a sentinel key, so
0xFFFFFFFF keys stay correct.
"""

from __future__ import annotations

import torch

from ..batch import FIELD_NUM, FIELD_RECID, RecordBatch, canonical_field
from ..kernels.compact import compact_words
from ..kernels.sorted_probe import sorted_probe
from .sort import packed_u32_view_sort, sorted_adjacent_equal

U32_MAX_BITS = -1  # 0xFFFFFFFF as an int32 word


def is_u32_field(field) -> bool:
    return canonical_field(field) in (FIELD_RECID, FIELD_NUM)


def u32_key(batch: RecordBatch, field) -> torch.Tensor:
    return batch.recid if canonical_field(field) == FIELD_RECID else batch.num


def masked_sorted_key(key_sorted_live: torch.Tensor, count) -> torch.Tensor:
    """Replace the dead tail with U32_MAX so the whole array is monotone.

    Safe for the search because matches are gated on ``pos < count``: a
    live U32_MAX key sits at position count-1 and still matches; padding
    never does."""
    n = key_sorted_live.shape[0]
    live = torch.arange(n, device=key_sorted_live.device) < count
    return torch.where(live, key_sorted_live, U32_MAX_BITS)


def _inactive(n: int, count, device) -> torch.Tensor:
    if count is None:
        return torch.zeros(n, dtype=torch.bool, device=device)
    return torch.arange(n, dtype=torch.int32, device=device) >= count


def distinct_u32(batch: RecordBatch, field, count=None) -> tuple[RecordBatch, torch.Tensor]:
    """DISTINCT for u32 fields with a single payload gather.  Returns (batch
    of the input's capacity, nunique); survivors in key order, the lowest
    row of each key, rows past nunique zero."""
    n = batch.nrows
    key = u32_key(batch, field)
    s_key, perm, s_act, _ = packed_u32_view_sort(_inactive(n, count, key.device), key)
    keep = s_act & ~sorted_adjacent_equal(s_key)[:n]
    nunique, (orig,) = compact_words(keep, (perm,))
    return batch.take_fill(orig, count=nunique), nunique


def hash_join_count_u32(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    build_count=None,
    probe_count=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(matched, mult, nres) for u32 fields: key-column traffic only.  The
    build side collapses to a key set, so a hit's multiplicity is 1."""
    nb = build.nrows
    bkey = u32_key(build, field)
    s_key, _, _, _ = packed_u32_view_sort(_inactive(nb, build_count, bkey.device), bkey)
    count = nb if build_count is None else build_count
    hit, mult = sorted_probe(masked_sorted_key(s_key, count), count, u32_key(probe, field),
                             probe_count)
    return hit, mult, mult.sum(dtype=torch.int32)
