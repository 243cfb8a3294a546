"""Duplicate elimination (sort-based DISTINCT on the join field).

Port of the JAX package's ``ops/distinct.py`` on the gather route.
Reference semantics (``DatabaseProject.cpp:94-170``): sort by the field,
then keep the first record of each equal-key group, survivors in sorted key
order; ``nunique`` counts the unique keys.  Which record of a duplicate
group survives is the lowest original row (the sort's total order).

One key sort (K1 or K5 with K6), one compaction (K3) and one record gather
(K4).  Beyond ``cfg.mem_rows`` the public ``distinct`` takes the chunked
route (``ops/chunked.py``).
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..utils.checks import ensure_device_budget
from .keys import adjacent_equal
from .movement import compact_rows
from .sort import SortedView, materialize_survivors, sort_keys


def distinct_view(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
    active: torch.Tensor | None = None,
) -> tuple[SortedView, torch.Tensor]:
    """Key-level DISTINCT: returns (view, keep_sorted) without moving rows.

    keep_sorted marks, in sorted order, the first row of each live key
    group.  Live rows are the first `count` rows and, where an `active`
    mask is given (a filter predicate), those it marks: the two compose.
    Inactive rows sink to the sort's tail.
    """
    n = batch.nrows
    if count is not None:
        live = torch.arange(n, dtype=torch.int32, device=batch.recid.device) < count
        active = live if active is None else active & live
    pre = ()
    extra = ()
    if active is not None:
        pre = (~active,)
        extra = (active.to(torch.int32),)
    view = sort_keys(batch, field, cfg, pre_words=pre, extra=extra, pre_is_mask=True)
    keep = ~view.adj_eq
    if active is not None:
        keep &= view.extras[0] == 1
    return view, keep


def distinct_sorted(
    sorted_batch: RecordBatch, field, count=None
) -> tuple[RecordBatch, torch.Tensor]:
    """DISTINCT over an already key-sorted batch.  Returns (batch, nunique)."""
    keep = ~adjacent_equal(sorted_batch, field)
    if count is not None:
        n = sorted_batch.nrows
        keep &= torch.arange(n, dtype=torch.int32, device=keep.device) < count
    out, n_unique, _ = compact_rows(sorted_batch, keep)
    return out, n_unique


def distinct_impl(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
    active: torch.Tensor | None = None,
) -> tuple[RecordBatch, torch.Tensor]:
    """Sort + DISTINCT (the reference's EliminateDuplicates pipeline).

    Returns (batch of the input's capacity, nunique); output rows are in
    sorted key order and rows past nunique are zero.  `count` marks live
    rows under the static-capacity convention; `active` is an additional
    liveness mask (see distinct_view).
    """
    ensure_device_budget(batch.nrows, cfg, "distinct")
    if cfg.u32_distinct_engine != "generic":
        raise NotImplementedError(
            f"u32_distinct_engine={cfg.u32_distinct_engine!r}: the alternative "
            "distinct engines are not ported yet (ROADMAP.md, Queue 1 item 12)"
        )
    view, keep = distinct_view(batch, field, cfg, count=count, active=active)
    return materialize_survivors(batch, view.perm, keep, cfg)


def distinct(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
    active: torch.Tensor | None = None,
) -> tuple[RecordBatch, torch.Tensor]:
    """The public form: batches beyond ``cfg.mem_rows`` route through the
    chunked route (``ops/chunked.py``) instead of raising; the core
    ``distinct_impl`` keeps its budget gate."""
    if batch.nrows > cfg.mem_rows:
        from .chunked import distinct_chunked

        return distinct_chunked(batch, field, cfg, count, active=active)
    return distinct_impl(batch, field, cfg, count, active)
