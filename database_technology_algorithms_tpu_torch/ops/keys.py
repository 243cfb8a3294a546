"""Sort/join key extraction (port of the JAX package's ``ops/keys.py``).

A key is a list of u32 words (int32 tensors), most significant first:
recid and num are one word; str is the packed string words; (num, str) is
[num] ++ str words.  String words are column views of ``strw`` (row stride
K): the kernels that read keys (K5, K6, K8) take strided columns, so no word
is copied out.  ``hash_words`` is kernel K8 (``kernels/hash_words.py``).
"""

from __future__ import annotations

import torch

from ..batch import FIELD_NUM, FIELD_NUMSTR, FIELD_RECID, FIELD_STR, RecordBatch, canonical_field
from ..kernels.adj_equal import adj_equal
from ..kernels.hash_words import hash_words

__all__ = [
    "str_key_words", "key_words", "uses_strings", "rows_equal_on_field", "adjacent_equal",
    "hash_words", "key_hash",
]


def str_key_words(strw: torch.Tensor, nwords: int) -> list[torch.Tensor]:
    """First nwords packed string words (most significant first), as views."""
    return [strw[:, j] for j in range(nwords)]


def key_words(batch: RecordBatch, field, nwords: int | None = None) -> list[torch.Tensor]:
    """Key word list for `field`; nwords limits the string words (None = all
    stored words, which is exact by the narrow-width invariant)."""
    field = canonical_field(field)
    if field == FIELD_RECID:
        return [batch.recid]
    if field == FIELD_NUM:
        return [batch.num]
    sw = batch.str_words if nwords is None else min(nwords, batch.str_words)
    if field == FIELD_STR:
        return str_key_words(batch.strw, sw)
    if field == FIELD_NUMSTR:
        return [batch.num] + str_key_words(batch.strw, sw)
    raise ValueError(field)


def uses_strings(field) -> bool:
    return canonical_field(field) in (FIELD_STR, FIELD_NUMSTR)


def rows_equal_on_field(batch: RecordBatch, field, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Exact key equality between row sets i and j (full width, never
    prefixed), elementwise.  The sorted-neighbour form the engine needs,
    ``(perm[:-1], perm[1:])``, is ``adjacent_equal(batch, field, perm)``
    (kernel K6), which gathers no rows."""
    i, j = i.long(), j.long()
    eq = torch.ones(i.shape, dtype=torch.bool, device=i.device)
    for w in key_words(batch, field):
        eq &= w[i] == w[j]
    return eq


def adjacent_equal(batch: RecordBatch, field, perm: torch.Tensor | None = None) -> torch.Tensor:
    """bool[N]: row k has the same full key as row k-1 (element 0 is False).
    With `perm` (sorted position -> row) the rows are read in sorted order,
    which is ``rows_equal_on_field(batch, field, perm[:-1], perm[1:])`` with
    a leading False."""
    return adj_equal(key_words(batch, field), perm)


def key_hash(batch: RecordBatch, field, seed: int = 0) -> torch.Tensor:
    """u32 hash (int32 bits) of each row's full key, the same at every stored
    strw width: zero string words are skipped, while the num word of field 3
    (where 0 is a legal key value) always hashes."""
    field = canonical_field(field)
    skip = (1 if field == FIELD_NUMSTR else 0) if uses_strings(field) else None
    return hash_words(key_words(batch, field), seed=seed, skip_zero_from=skip)
