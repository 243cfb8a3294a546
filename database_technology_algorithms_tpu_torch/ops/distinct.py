"""Duplicate elimination (sort-based DISTINCT on the join field).

Port of the JAX package's ``ops/distinct.py``, both routes.
Reference semantics (``DatabaseProject.cpp:94-170``): sort by the field,
then keep the first record of each equal-key group, survivors in sorted key
order; ``nunique`` counts the unique keys.  Which record of a duplicate
group survives is the lowest original row (the sort's total order).

One key sort (K1 or K5 with K6), then on the gather route one compaction
(K3) and one record gather (K4).  The placement route places the survivors
directly for the u32 fields (K7 and ``place_join_by_key``) and through
``survivor_dest`` otherwise.  Beyond ``cfg.mem_rows`` the public
``distinct`` takes the chunked route (``ops/chunked.py``).
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch, canonical_field
from ..config import DEFAULT_CONFIG, EngineConfig
from ..utils.checks import ensure_device_budget
from .keys import adjacent_equal
from .movement import compact_rows, packed_keep_backsort, packed_placement, place_join_by_key
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
    fld = canonical_field(field)
    if fld in (0, 1) and cfg.u32_distinct_engine == "fastpath" and active is None:
        # the JAX package's only dispatch away from the generic path
        from .fastpath import distinct_u32

        return distinct_u32(batch, fld, count=count)
    view, keep = distinct_view(batch, fld, cfg, count=count, active=active)
    n = batch.nrows
    if packed_placement(cfg, fld, batch.str_words) and n < (1 << 30):
        # "survivors first, in key order" is an order of the batch by
        # (dropped, key, row): the keep mask back to row order (K7), then
        # the placement by key with the key column rebuilt
        nunique = keep.sum(dtype=torch.int32)
        keep_orig = packed_keep_backsort(view.perm, keep, n)
        key = batch.recid if fld == 0 else batch.num
        out = place_join_by_key(keep_orig, key, nunique, batch,
                                key_plane="recid" if fld == 0 else "num")
        return out, nunique
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
