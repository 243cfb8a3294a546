"""Row-count truncation (the part of the JAX package's ``ops/filter.py``
that the ported CLI needs)."""

from __future__ import annotations

from ..batch import RecordBatch


def truncate(batch: RecordBatch, count) -> RecordBatch:
    """Host-side: keep only the first `count` rows."""
    c = int(count)
    return RecordBatch(
        recid=batch.recid[:c],
        num=batch.num[:c],
        strw=batch.strw[:c],
        valid=batch.valid[:c],
    )
