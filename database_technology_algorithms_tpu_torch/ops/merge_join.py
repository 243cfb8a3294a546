"""Sort-merge join (distinct-key intersection, R-side emission).

Port of the JAX package's ``ops/merge_join.py`` on the gather route.
Reference semantics (``DatabaseProject.cpp:384-502``): MergeJoin runs
EliminateDuplicates on both inputs, so the join is a set-semantics join on
distinct key values, and emits, for each key present on both sides, the
R-side record only.  ``nres`` is the matched-key count.

The serial two-pointer loop becomes a sorted-concatenation intersection:
key-sort R||S by (inactive, key, row); each side's keys being unique, every
matched key is an adjacent [R, S] pair, one adjacency check finds them and
one record gather emits the matched R records.  Padding rows (capacity
beyond the live count) sort to the tail and never match.
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from .distinct import distinct_impl
from .sort import materialize_survivors, sort_keys


def join_view(
    r: RecordBatch,
    r_count,
    s: RecordBatch,
    s_count,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
):
    """Key-level intersection core over the concatenated pair.

    Returns (concat_batch, view, matched_sorted): matched_sorted marks, at
    sorted positions, the R row of each matched [R, S] adjacency.
    """
    nr = r.nrows
    both = RecordBatch.concat([r, s])
    n = both.nrows
    idx = torch.arange(n, dtype=torch.int32, device=both.recid.device)
    active = torch.where(idx < nr, idx < r_count, (idx - nr) < s_count)
    # side is neither a sort word nor payload: the row index, the last sort
    # key, is monotone in side (R rows occupy [0, nr)), so R sorts before S
    # within a key and the sorted side is perm >= nr
    view = sort_keys(
        both, field, cfg,
        pre_words=(~active,),
        extra=(active.to(torch.int32),),
        pre_is_mask=True,
    )
    s_act = view.extras[0] == 1
    s_side = view.perm >= nr
    pair = view.adj_eq[1:] & ~s_side[:-1] & s_side[1:] & s_act[:-1] & s_act[1:]
    matched = torch.cat([pair, pair.new_zeros(1)])
    return both, view, matched


def join_sorted_distinct_impl(
    r: RecordBatch,
    r_count,
    s: RecordBatch,
    s_count,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor]:
    """Intersect two batches whose first r_count/s_count rows hold unique keys.

    Returns (r_matched, nres): R rows whose key also appears in S, in sorted
    key order, compacted to the front of an R-capacity batch.  Matched rows
    are always R rows, so the record gather reads R alone.
    """
    _, view, matched = join_view(r, r_count, s, s_count, field, cfg)
    return materialize_survivors(r, view.perm, matched, cfg)


join_sorted_distinct = join_sorted_distinct_impl


def merge_join_impl(
    r: RecordBatch,
    s: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor, dict]:
    """Full reference MergeJoin pipeline: distinct(R), distinct(S), intersect.

    Returns (r_matched_batch, nres, stats dict with nunique_r/nunique_s).
    """
    r_d, nu_r = distinct_impl(r, field, cfg)
    s_d, nu_s = distinct_impl(s, field, cfg)
    out, nres = join_sorted_distinct_impl(r_d, nu_r, s_d, nu_s, field, cfg)
    return out, nres, {"nunique_r": nu_r, "nunique_s": nu_s}


merge_join = merge_join_impl
