"""Group-by aggregate: count, sum, min and max of ``num`` per key.

Port of the JAX package's ``ops/aggregate.py``, both phases.  One key sort
carries the measures as extra words (K1 for fields 0-1 under
``packed_u32_sorts``, K5 and K6 otherwise); the run aggregate K13
(``kernels/run_aggregate.py``) reduces each run of equal keys among the
active rows in one pass over the sorted rows; the group representatives
(the first row of each group, in key order) come from
``materialize_survivors``: K3 and K4 on the gather route, the placements on
the others.

``group_aggregate`` is the same function as ``group_aggregate_impl``: torch
runs eagerly, so the JAX package's jit wrapper has no counterpart.
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.run_aggregate import run_aggregate
from .sort import SortedView, materialize_survivors, sort_keys


def _run_aggregates(
    batch: RecordBatch,
    view: SortedView,
    active_s: torch.Tensor,
    vals: tuple,
    cfg: EngineConfig,
    materialize_reps: bool,
) -> tuple[RecordBatch, dict, torch.Tensor]:
    """Shared tail of both phases: the aggregates of each run of
    ``active_s & ~view.adj_eq`` (K13) and, with ``materialize_reps``, the
    group representatives; otherwise a one-row placeholder, as in JAX."""
    aggs, n_groups = run_aggregate(active_s, view.adj_eq, vals)
    if materialize_reps:
        reps, _ = materialize_survivors(batch, view.perm, active_s & ~view.adj_eq, cfg)
    else:
        reps = batch.slice(0, 1)  # placeholder; callers using counters only
    return reps, aggs, n_groups


def _live(n: int, count, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device) < count


def group_aggregate_impl(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
    active: torch.Tensor | None = None,
    materialize_reps: bool = True,
) -> tuple[RecordBatch, dict, torch.Tensor]:
    """Group by `field`; aggregate `num` per group.

    Returns (group_rep_batch, aggs, n_groups): the first record of each
    group, in sorted key order, compacted to the front; aggs = {"count",
    "sum", "min", "max"} int32 columns (u32 bits but for count) aligned with
    those rows.  `count` marks live rows (static-capacity convention) and
    composes with an `active` mask: padding rows never form a group.
    """
    n = batch.nrows
    if count is not None:
        live = _live(n, count, batch.recid.device)
        active = live if active is None else active & live
    pre, extra0 = (), ()
    if active is not None:
        pre = (~active,)
        extra0 = (active.to(torch.int32),)
    # the measure rides through the key sort: no record moves for the
    # aggregates themselves
    view = sort_keys(batch, field, cfg, pre_words=pre, extra=extra0 + (batch.num,),
                     pre_is_mask=True)
    active_s = (torch.ones(n, dtype=torch.bool, device=batch.recid.device) if not extra0
                else view.extras[0] == 1)
    return _run_aggregates(batch, view, active_s, (view.extras[-1],), cfg, materialize_reps)


group_aggregate = group_aggregate_impl


def combine_group_aggregate_impl(
    batch: RecordBatch,
    field,
    partials: tuple,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
    materialize_reps: bool = True,
) -> tuple[RecordBatch, dict, torch.Tensor]:
    """Merge PARTIAL per-key aggregates into global ones (the combine step
    of two-phase aggregation).

    ``partials`` = (count, sum, min, max) int32 columns (u32 bits) aligned
    with `batch`'s rows, each row a group representative from some local
    ``group_aggregate``.  One key sort carries the four partial words; K13
    sums the counts (as int32, wrapping) and sums, and takes the unsigned
    min of the mins and max of the maxes.  Returns (group_rep_batch, aggs,
    n_groups) exactly like ``group_aggregate_impl``.
    """
    n = batch.nrows
    active = (torch.ones(n, dtype=torch.bool, device=batch.recid.device) if count is None
              else _live(n, count, batch.recid.device))
    view = sort_keys(batch, field, cfg, pre_words=(~active,),
                     extra=(active.to(torch.int32), *partials), pre_is_mask=True)
    s_act, *s_partials = view.extras
    return _run_aggregates(batch, view, s_act == 1, tuple(s_partials), cfg, materialize_reps)
