"""Masked selection filter and compaction.

Port of the JAX package's ``ops/filter.py``.  A predicate is an elementwise
torch expression that maps a batch to a bool mask (no kernel: the JAX
package's predicates are plain ``jnp`` comparisons); ``compact`` moves the
rows it keeps to the front through ``compact_rows`` (K3 and K4 on the gather
route, ``permute_rows`` on the placement routes).

The output keeps the input's capacity; the true row count rides alongside
as a 0-d tensor on the device, and rows past it are zero with valid False.
u32 words are int32 bit patterns, so the range predicates compare them
unsigned: flipping bit 31 maps the u32 order onto the int32 order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..batch import STR_PAD, RecordBatch, normalize_str_bytes, pack_str_bytes
from ..config import DEFAULT_CONFIG, EngineConfig
from .movement import compact_rows

_SIGN = -(1 << 31)  # bit 31 as an int32


def compact(
    batch: RecordBatch,
    mask: torch.Tensor,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
) -> tuple[RecordBatch, torch.Tensor]:
    """Move rows where `mask` is True to the front, order preserved.

    Returns (batch of the same capacity, count); rows past `count` are zero.
    With ``count``, only the first ``count`` input rows are live: zeroed
    padding rows could otherwise pass a predicate (num=0, str='')."""
    if count is not None:
        mask = mask & (torch.arange(batch.nrows, dtype=torch.int32, device=mask.device) < count)
    out, cnt, _ = compact_rows(batch, mask, cfg=cfg)
    return out, cnt


def truncate(batch: RecordBatch, count) -> RecordBatch:
    """Host-side: keep only the first `count` rows."""
    return batch.slice(0, int(count))


# ---- predicates ------------------------------------------------------------

Predicate = Callable[[RecordBatch], torch.Tensor]


def _u32_order(x: torch.Tensor) -> torch.Tensor:
    """int32 bits whose signed order is the u32 order of `x`'s bits."""
    return x ^ _SIGN


def _u32_bound(v: int) -> int:
    """A u32 bound (the JAX package's ``jnp.uint32(v)``, which refuses values
    outside [0, 2^32)) in the order of ``_u32_order``."""
    return int(np.uint32(v)) + _SIGN


def _range(col: torch.Tensor, lo, hi) -> torch.Tensor:
    m = torch.ones(col.shape[0], dtype=torch.bool, device=col.device)
    key = _u32_order(col)
    if lo is not None:
        m &= key >= _u32_bound(lo)
    if hi is not None:
        m &= key < _u32_bound(hi)
    return m


def pred_valid() -> Predicate:
    """The reference-format selection predicate: record.valid is set."""
    return lambda b: b.valid


def pred_num_range(lo: int | None = None, hi: int | None = None) -> Predicate:
    """``lo <= num < hi`` in u32 order; a bound left as None is open."""
    return lambda b: _range(b.num, lo, hi)


def pred_recid_range(lo: int | None = None, hi: int | None = None) -> Predicate:
    """``lo <= recid < hi`` in u32 order; a bound left as None is open."""
    return lambda b: _range(b.recid, lo, hi)


def pred_str_eq(s: bytes) -> Predicate:
    """String equality (strcmp == 0 semantics on NUL-normalized bytes)."""
    const = np.zeros((1, STR_PAD), dtype=np.uint8)
    raw = np.frombuffer(s[:STR_PAD], dtype=np.uint8)
    const[0, : len(raw)] = raw
    # the constant gets the same NUL-normalization as ingested strings:
    # bytes after an embedded NUL are strcmp-invisible, and stored rows
    # have zeros there
    const_w = pack_str_bytes(normalize_str_bytes(const))[0]
    const_bits = torch.from_numpy(const_w.view(np.int32).copy())

    def f(b: RecordBatch) -> torch.Tensor:
        k = b.str_words
        if np.any(const_w[k:]):
            # the constant extends past the batch's stored width, where
            # every string is zero: nothing can match
            return torch.zeros(b.nrows, dtype=torch.bool, device=b.strw.device)
        return (b.strw == const_bits[:k].to(b.strw.device)).all(-1)

    return f


def pred_and(*preds: Predicate) -> Predicate:
    def f(b: RecordBatch) -> torch.Tensor:
        m = preds[0](b)
        for p in preds[1:]:
            m = m & p(b)
        return m

    return f


def filter_batch(
    batch: RecordBatch,
    predicate: Predicate,
    count=None,
) -> tuple[RecordBatch, torch.Tensor]:
    """Evaluate `predicate`, compact the rows it keeps.  Returns (batch,
    count).  ``count`` marks the live prefix under the static-capacity
    convention (padding rows never pass, whatever the predicate says of
    zeros)."""
    return compact(batch, predicate(batch), count=count)
