"""Sort/join key extraction (port of the JAX package's ``ops/keys.py``).

A key is a list of u32 words (int32 tensors), most significant first:
recid and num are one word; str is the packed string words; (num, str) is
[num] ++ str words.
"""

from __future__ import annotations

import torch

from ..batch import FIELD_NUM, FIELD_NUMSTR, FIELD_RECID, FIELD_STR, RecordBatch, canonical_field


def str_key_words(strw: torch.Tensor, nwords: int) -> list[torch.Tensor]:
    """First nwords packed string words (most significant first)."""
    return [strw[:, j].contiguous() for j in range(nwords)]


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
