"""Row-count truncation (the part of the JAX package's ``ops/filter.py``
that the ported CLI needs)."""

from __future__ import annotations

from ..batch import RecordBatch


def truncate(batch: RecordBatch, count) -> RecordBatch:
    """Host-side: keep only the first `count` rows."""
    return batch.slice(0, int(count))
