"""The composed query pipeline (port of the JAX package's ``models/pipeline.py``,
all four key fields, both materialization routes; beyond the device budget
the staged runner composes the chunked distinct, the tiled join and the
chunked compaction).

The reference driver's workload (``main.cpp:109-123``) is MergeJoin
(sort -> distinct -> two-pointer join) followed by HashJoin on the dedup'd
inputs, cross-checking pair counts.  As in the JAX package, everything is
derived from ONE sort of R||S by (inactive, key, row): both sides' distinct
counts, the merge-join pair set, the hash-join cross-check and the group
aggregates, then one record gather materializes the join output.

Kernel launches per staged run: K1 once (the view sort; for the string
fields 2 and 3 K5 and K6 instead), K2 three times (the forward run-head
carry, the reversed any-S max, the compaction's rank scan), K3 once
(compaction of the sorted row indices), K4 once (the record gather).  The
flag and counter arithmetic between them is plain torch.  On the placement
route (``materialize="sort"``) stage B of fields 0 and 1 is K7 (the matched
mask back to R's order) and ``place_join_by_key`` (K1 over R, K4); the
other fields and ``"sort2d"`` place ``survivor_dest``'s destinations (one
more K2 scan, K7, then K1 and K4, or K1 and K12 for ``"sort2d"``).
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch, as_u32, canonical_field, u32_bits
from ..config import DEFAULT_CONFIG, EngineConfig
from ..ops.keys import key_words
from ..ops.movement import (
    compact_words, packed_keep_backsort, packed_placement, permute_rows, place_join_by_key,
    use_sort_placement)
from ..ops.scan import cumsum, seg_carry, seg_max, seg_min
from ..ops.sort import (
    SortedView, materialize_survivors, packed_u32_view_sort, sort_keys, sorted_adjacent_equal,
    survivor_dest, view_sort_3key)
from ..utils.checks import ensure_device_budget


def _shift_in(x: torch.Tensor, fill, at_end: bool = False) -> torch.Tensor:
    """x shifted one place (x[i-1], or x[i+1] with at_end), `fill` entering."""
    pad = torch.full((1,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[1:], pad]) if at_end else torch.cat([pad, x[:-1]])


def _pipeline_view(both: RecordBatch, nr: int, field: int, cfg: EngineConfig):
    """The pipeline's one sort: actives first, by key, R before S within a
    key (the row index is monotone in side).

    Returns (view, adj, is_r, is_s, prev_side, v_num); ``prev_side`` is True
    where the previous sorted row is an S row.
    """
    field = canonical_field(field)
    inact = ~both.valid
    if field in (0, 1):
        (kw,) = key_words(both, field)
        extra = () if field == 1 else (both.num,)
        sort = packed_u32_view_sort if cfg.packed_u32_sorts else view_sort_3key
        s_key, perm, v_act, ex = sort(inact, kw, extra)
        v_num = s_key if field == 1 else ex[0]
        adj = sorted_adjacent_equal(s_key)
    else:
        view = sort_keys(both, field, cfg, pre_words=(inact,),
                         extra=(both.valid.to(torch.int32), both.num))
        v_act_w, v_num = view.extras
        v_act = v_act_w == 1
        perm, adj = view.perm, view.adj_eq
    v_side = perm >= nr
    is_r = v_act & ~v_side
    is_s = v_act & v_side
    prev_side = _shift_in(v_side, False)
    return SortedView(perm=perm, adj_eq=adj, extras=()), adj, is_r, is_s, prev_side, v_num


def _stage_a_flags(adj, is_r, is_s, prev_side):
    """Distinct firsts, run-has-R and the matched R survivor of each key."""
    r_first = is_r & ~adj
    s_first = is_s & ~(adj & prev_side)
    is_start = ~adj
    run_has_r = seg_carry(is_start, r_first) == 1
    # any active S at or after each row within its run: a reversed max scan
    # that restarts at each run's END
    end_flags = _shift_in(is_start, True, at_end=True)
    any_s_suffix = seg_max(end_flags, is_s, reverse=True) == 1
    matched = r_first & any_s_suffix
    return r_first, s_first, run_has_r, matched


def pipeline_single_impl(
    r: RecordBatch,
    s: RecordBatch,
    field: int = 1,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> dict:
    """The full single-device plan from one sort: the reference driver's
    counters, the per-key aggregates over S (count, u32 sum, min, max of
    num) and the merge-join output batch."""
    nr, ns = r.nrows, s.nrows
    n = nr + ns
    ensure_device_budget(n, cfg, "pipeline_single")
    use_sort_placement(cfg)
    both = RecordBatch.concat([r, s])
    view, adj, is_r, is_s, prev_side, v_num = _pipeline_view(both, nr, field, cfg)
    r_first, s_first, run_has_r, matched = _stage_a_flags(adj, is_r, is_s, prev_side)
    nu_s = s_first.sum(dtype=torch.int32)
    mj_n = matched.sum(dtype=torch.int32)

    # group aggregates over the active S rows: S rows of a key are contiguous
    s_end = is_s & ~(_shift_in(adj, False, at_end=True) & _shift_in(is_s, False, at_end=True))
    c_incl = cumsum(is_s)
    s_incl = cumsum(torch.where(is_s, v_num, 0))
    run_min = seg_min(s_first, torch.where(is_s, v_num, -1))  # -1: u32 max
    run_max = seg_max(s_first, torch.where(is_s, v_num, 0))
    _, (ec, es, emin, emax) = compact_words(s_end, (c_incl, s_incl, run_min, run_max))
    live_g = torch.arange(n, device=ec.device) < nu_s
    aggs = {
        "count": torch.where(live_g, ec - _shift_in(ec, 0), 0)[:ns],
        "sum": torch.where(live_g, u32_bits(as_u32(es) - as_u32(_shift_in(es, 0))), 0)[:ns],
        "min": torch.where(live_g, emin, -1)[:ns],
        "max": torch.where(live_g, emax, 0)[:ns],
    }
    return {
        "nunique_r": r_first.sum(dtype=torch.int32),
        "nunique_s": nu_s,
        "merge_nres": mj_n,
        "hash_nres": (s_first & run_has_r).sum(dtype=torch.int32),
        "agg_groups": nu_s,
        "aggs": aggs,
        # matched rows are always R rows, so the record gather reads R alone
        "join_out": materialize_survivors(r, view.perm, matched, cfg)[0],
        "join_count": mj_n,
    }


def make_pipeline_staged(field: int = 1, cfg: EngineConfig = DEFAULT_CONFIG):
    """Build the staged runner: ``run(r, s)`` returns the reference driver's
    counters and the join output, as ``pipeline_single_impl`` does without
    the aggregates.  ``run.stage_a`` (the view sort, scans and counters) and
    ``run.materialize`` (the one record materialization) are exposed for
    per-stage timing, as in the JAX package.  Stage A hands stage B the
    words its route reads: ``perm`` and ``matched`` on the gather route,
    ``matched_r`` (the matched mask in R's row order) on the direct
    placement of the u32 fields, ``dest`` (R's destinations) otherwise.

    Inputs beyond ``cfg.mem_rows`` take the over-budget composition
    (``_run_overbudget``); ``run.stage_a`` itself keeps the budget gate.
    """
    fld = canonical_field(field)
    sort_route = use_sort_placement(cfg)

    def _direct_place(r: RecordBatch, s: RecordBatch) -> bool:
        return packed_placement(cfg, fld, r.str_words) and r.nrows + s.nrows < (1 << 30)

    def stage_a(r: RecordBatch, s: RecordBatch) -> dict:
        nr = r.nrows
        ensure_device_budget(nr + s.nrows, cfg, "pipeline_staged")
        both = RecordBatch.concat([r, s])
        view, adj, is_r, is_s, prev_side, _ = _pipeline_view(both, nr, fld, cfg)
        r_first, s_first, run_has_r, matched = _stage_a_flags(adj, is_r, is_s, prev_side)
        mj_n = matched.sum(dtype=torch.int32)
        out = {
            "nunique_r": r_first.sum(dtype=torch.int32),
            "nunique_s": s_first.sum(dtype=torch.int32),
            "merge_nres": mj_n,
            "hash_nres": (s_first & run_has_r).sum(dtype=torch.int32),
            "cnt": mj_n,
        }
        if not sort_route:
            out["perm"] = view.perm
            out["matched"] = matched
        elif _direct_place(r, s):
            out["matched_r"] = packed_keep_backsort(view.perm, matched, nr)
        else:
            out["dest"] = survivor_dest(view.perm, matched)[0][:nr]
        return out

    def materialize(out: dict, r: RecordBatch, s: RecordBatch) -> RecordBatch:
        """Stage B: the one record materialization from stage A's words."""
        if "matched_r" in out:
            return place_join_by_key(out["matched_r"], r.recid if fld == 0 else r.num,
                                     out["cnt"], r, key_plane="recid" if fld == 0 else "num")
        if "dest" in out:  # place_batch, or the payload words' place_words_2d for "sort2d"
            return permute_rows(r, out["dest"], out["cnt"], cfg)
        return materialize_survivors(r, out["perm"], out["matched"], cfg)[0]

    def _run_overbudget(r: RecordBatch, s: RecordBatch) -> dict:
        """Host-level composition from the operators that take any size:
        distinct through the chunked two-pass route, the intersection
        through the tiled join, materialization through gather chunks;
        every device program touches O(mem_rows) rows.  The same result
        dict as the in-budget runner."""
        from ..ops.chunked import compact_rows_chunked
        from ..ops.distinct import distinct
        from ..ops.hash_join import hash_join_count

        # the valid predicate is the pipeline's selection filter (an activity
        # mask in the in-budget view sort): the composition honours it too
        r_d, nu_r = distinct(r, fld, cfg, active=r.valid)
        s_d, nu_s = distinct(s, fld, cfg, active=s.valid)
        # matched R survivors in key order = the semi-join of the dedup'd
        # sides (a distinct build side makes field 3's multiplicities 1, so
        # nres is the intersection count for every field)
        m_r, _, mjn = hash_join_count(s_d, r_d, fld, cfg, build_count=nu_s, probe_count=nu_r)
        mj_out, _ = compact_rows_chunked(r_d, m_r, cfg)
        return {
            "nunique_r": nu_r,
            "nunique_s": nu_s,
            "merge_nres": mjn,
            # over dedup'd sides both cross-check counters are the same
            # intersection cardinality: no second tiled join
            "hash_nres": mjn,
            "agg_groups": nu_s,
            "join_out": mj_out,
            "join_count": mjn,
        }

    def run(r: RecordBatch, s: RecordBatch) -> dict:
        if r.nrows + s.nrows > cfg.mem_rows:
            return _run_overbudget(r, s)
        out = stage_a(r, s)
        return {
            "nunique_r": out["nunique_r"],
            "nunique_s": out["nunique_s"],
            "merge_nres": out["merge_nres"],
            "hash_nres": out["hash_nres"],
            "agg_groups": out["nunique_s"],
            "join_out": materialize(out, r, s),
            "join_count": out["merge_nres"],
        }

    run.stage_a = stage_a  # type: ignore[attr-defined]
    run.materialize = materialize  # type: ignore[attr-defined]
    return run
