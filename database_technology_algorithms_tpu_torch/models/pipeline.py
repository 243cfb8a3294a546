"""The composed query pipeline (port of the JAX package's ``models/pipeline.py``,
all four key fields, both materialization routes; beyond the device budget
the staged runner composes the chunked distinct, the tiled join and the
chunked compaction; ``make_dist_pipeline``, the distributed plan over a
shard mesh, and ``make_dist_pipeline_staged``, the same plan stage by stage
with per-stage checkpoints, at the end of the module).

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
from ..ops.aggregate import combine_group_aggregate_impl, group_aggregate_impl
from ..ops.distinct import distinct_impl
from ..ops.filter import compact
from ..ops.hash_join import hash_join_count_impl
from ..ops.keys import key_words
from ..ops.merge_join import join_sorted_distinct_impl
from ..ops.movement import (
    compact_words, packed_keep_backsort, packed_placement, permute_rows, place_join_by_key,
    use_sort_placement)
from ..ops.scan import cumsum, seg_carry, seg_max, seg_min
from ..ops.sort import (
    SortedView, materialize_survivors, packed_u32_view_sort, sort_keys, sorted_adjacent_equal,
    survivor_dest, view_sort_3key)
from ..parallel.dist_ops import hash_dest
from ..parallel.mesh import mesh_size
from ..parallel.overlap import overlap_key_words, overlapped_join_local
from ..parallel.shuffle import shuffle_with_extra
from ..parallel.skew import skew_join_local
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


# ---------------------------------------------------------------------------
# the distributed plan over a shard mesh


def _dist_caps(nrow_r: int, nrow_s: int, ndev: int, cfg: EngineConfig):
    cap_r = max(int(nrow_r * cfg.shuffle_slack) // ndev + 1, 64)
    cap_s = max(int(nrow_s * cfg.shuffle_slack) // ndev + 1, 64)
    return cap_r, cap_s


def _dist_stage_local(rb: RecordBatch, rc, sb: RecordBatch, sc, field, cfg: EngineConfig):
    """Stage 1 on one shard, no collectives: the filter (valid rows below
    the live count), the local dedup of R and the partial aggregates of S."""
    rf, rcf = compact(rb, rb.valid & (torch.arange(rb.nrows, device=rb.valid.device) < rc), cfg)
    sf, scf = compact(sb, sb.valid & (torch.arange(sb.nrows, device=sb.valid.device) < sc), cfg)
    rloc, nur_loc = distinct_impl(rf, field, cfg, count=rcf)
    sloc, s_pagg, nus_loc = group_aggregate_impl(sf, field, cfg, count=scf,
                                                 materialize_reps=True)
    return rloc, nur_loc, sloc, s_pagg, nus_loc


def _dist_stage_shuffle(mesh, rloc: list, nur_loc: list, sloc: list, s_pagg: list,
                        nus_loc: list, field, cfg: EngineConfig, cap_r: int, cap_s: int):
    """Stage 2, the exchange: one hash-partition all-to-all a table; S's
    partial aggregates ride as extra words."""
    ndev = mesh_size(mesh)
    rsh, _, rtot, ovf1 = shuffle_with_extra(
        mesh, rloc, nur_loc, [hash_dest(b, field, ndev) for b in rloc], cap_r, cfg,
        nchunks=cfg.shuffle_nchunks)
    ssh, s_px, stot, ovf2 = shuffle_with_extra(
        mesh, sloc, nus_loc, [hash_dest(b, field, ndev) for b in sloc], cap_s, cfg,
        extras=[(p["count"], p["sum"], p["min"], p["max"]) for p in s_pagg],
        nchunks=cfg.shuffle_nchunks)
    return rsh, rtot, ssh, s_px, stot, [a + b for a, b in zip(ovf1, ovf2)]


def _dist_stage_join(mesh, rsh: list, rtot: list, ssh: list, s_px: list, stot: list, field,
                     cfg: EngineConfig, cap_r: int, cap_s: int) -> dict:
    """Stage 3, colocated: the global dedup and combine, the merge join, the
    HashJoin cross-check under ``cfg.dist_join_engine``, the counters summed
    over the shards."""
    ndev = mesh_size(mesh)
    joined = []
    for r, rt, s, px, st in zip(rsh, rtot, ssh, s_px, stot):
        r_d, nu_r = distinct_impl(r, field, cfg, count=rt)
        s_d, agg, nu_s = combine_group_aggregate_impl(s, field, px, cfg, count=st,
                                                      materialize_reps=True)
        joined.append((r_d, nu_r, s_d, nu_s, agg,
                       *join_sorted_distinct_impl(r_d, nu_r, s_d, nu_s, field, cfg)))
    rd, nur, sd, nus, aggs, mj_out, mjn = (list(x) for x in zip(*joined))

    # the HashJoin cross-check on the dedup'd intermediates (main.cpp:121) by
    # the configured engine; every engine gives the same count.  The sides
    # are already hash-colocated, so the engines run with colocated=True
    # and skip their exchanges.
    engine = cfg.dist_join_engine
    if engine == "skew":
        cap_hot = min(max(2 * ndev * cfg.hh_topk, 64), rd[0].nrows)
        _, _, hjn, hj_ovf, _ = skew_join_local(mesh, rd, nur, sd, nus, field, cfg,
                                               cap_r, cap_s, cap_hot, colocated=True)
    elif engine == "overlap" and (overlap_key_words(rd[0], field) is not None
                                  and overlap_key_words(sd[0], field) is not None):
        chunks = max(cfg.shuffle_nchunks, 2)
        _, _, hjn, hj_ovf = overlapped_join_local(mesh, rd, nur, sd, nus, field, cfg, cap_r,
                                                  cap_s, -(-cap_s // chunks), chunks,
                                                  colocated=True)
    else:
        hjn = mesh.psum([hash_join_count_impl(r, s, field, cfg, build_count=a, probe_count=b)[2]
                         for r, s, a, b in zip(rd, sd, nur, nus)])
        hj_ovf = [torch.zeros((), dtype=torch.int32, device=d) for d in mesh.devices]

    nus_g = mesh.psum(nus)[0]
    return {
        "nunique_r": mesh.psum(nur)[0],
        "nunique_s": nus_g,
        "merge_nres": mesh.psum(mjn)[0],
        "hash_nres": hjn[0],
        "agg_groups": nus_g,
        "join_out": mj_out,
        "join_counts": mjn,
        "agg_count": [a["count"] for a in aggs],
        "agg_sum": [a["sum"] for a in aggs],
        "overflow": hj_ovf[0],
    }


def make_dist_pipeline(mesh, field: int = 1, cfg: EngineConfig = DEFAULT_CONFIG):
    """The distributed plan over the shards of `mesh`.

    Returns ``step(r_batches, r_counts, s_batches, s_counts)``, one batch and
    one live count a shard (a ``DistTable``'s ``batches`` and ``counts``),
    which returns the JAX package's dict: the counters of ``pipeline_single``
    summed over the shards (``nunique_r``, ``nunique_s``, ``merge_nres``,
    ``hash_nres``, ``agg_groups``; 0-d int32), a list a shard of
    ``join_out``, ``join_counts``, ``agg_count`` and ``agg_sum``, and
    ``overflow`` (0-d int32).

    The plan is local-first: each shard filters, dedups R and aggregates S
    on its own rows (stage 1), so a key moves at most one row a shard a
    side; one hash-partition all-to-all a table follows, S's partial
    (count, sum, min, max) riding as extra words (stage 2; in
    ``cfg.shuffle_nchunks`` slices); then, colocated, the global dedup,
    the combine of the partials, the merge join and the HashJoin
    cross-check under ``cfg.dist_join_engine`` ("sorted", "skew" or
    "overlap"; all exact) (stage 3).  The stages are this module's
    ``_dist_stage_local``, ``_dist_stage_shuffle`` and ``_dist_stage_join``,
    run by :func:`make_dist_pipeline_staged` with nothing checkpointed.
    """
    return make_dist_pipeline_staged(mesh, field, cfg)


BATCH_COLS = ("recid", "num", "strw", "valid")
AGG_COLS = ("count", "sum", "min", "max")


def make_dist_pipeline_staged(mesh, field: int = 1, cfg: EngineConfig = DEFAULT_CONFIG,
                              ckpt_dir: str | None = None, fail_after: str | None = None):
    """The distributed plan as its three stages (``_dist_stage_local``,
    ``_dist_stage_shuffle``, ``_dist_stage_join``), the one sequence behind
    :func:`make_dist_pipeline`.  With `ckpt_dir`, each stage's outputs are
    checkpointed there (per-process npz shards and a manifest,
    ``parallel/checkpoint.StageCheckpoints``), so that a re-run skips the
    stages done and re-runs only the one that failed.  `fail_after`
    ("local" or "shuffle") is the fault injection: the process exits (17)
    right after the named stage checkpointed.

    Returns ``run(r_batches, r_counts, s_batches, s_counts)``, which returns
    :func:`make_dist_pipeline`'s dict; with `ckpt_dir` it also holds
    ``resumed_stages``, the stages loaded from the manifest.  The
    checkpoint ties itself to the run's input shapes, field and plan
    settings, and to each process's input content; a run that completes
    removes its files."""
    from ..parallel.checkpoint import InjectedStageFailure, StageCheckpoints, local_content_tag

    ndev = mesh_size(mesh)

    def batches(values: dict, side: str) -> list:
        return [RecordBatch(*(values[f"{side}_{c}"][j] for c in BATCH_COLS))
                for j in range(len(mesh.devices))]

    def columns(bs: list, side: str) -> dict:
        return {f"{side}_{c}": [getattr(b, c) for b in bs] for c in BATCH_COLS}

    def run(rb: list, rc: list, sb: list, sc: list) -> dict:
        cap_r, cap_s = _dist_caps(rb[0].nrows, sb[0].nrows, ndev, cfg)
        resumed: list[str] = []
        ckpt = None
        if ckpt_dir:
            ckpt = StageCheckpoints(
                ckpt_dir, mesh,
                fingerprint={
                    "field": field if isinstance(field, str) else int(field),
                    "ndev": ndev,
                    "shapes": [rb[0].nrows * ndev, sb[0].nrows * ndev, rb[0].str_words,
                               sb[0].str_words],
                    "cfg": [cfg.shuffle_slack, cfg.shuffle_nchunks, cfg.dist_join_engine,
                            cfg.packed_u32_sorts],
                },
                local_tag=local_content_tag(
                    [getattr(b, c) for b in rb + sb for c in BATCH_COLS] + rc + sc))

        # ---- stage 1: local (filter, dedup, partial aggregates) -------------------
        if ckpt is not None and ckpt.stage_done("local"):
            a = ckpt.load_stage("local")
            rloc, sloc = batches(a, "r"), batches(a, "s")
            nur_loc, nus_loc = a["r_cnt"], a["s_cnt"]
            s_pagg = [{k: a[f"pg_{k}"][j] for k in AGG_COLS} for j in range(len(rloc))]
            resumed.append("local")
        else:
            local = [_dist_stage_local(r, a, s, b, field, cfg)
                     for r, a, s, b in zip(rb, rc, sb, sc)]
            rloc, nur_loc, sloc, s_pagg, nus_loc = (list(x) for x in zip(*local))
            if ckpt is not None:
                ckpt.save_stage("local", {
                    **columns(rloc, "r"), "r_cnt": nur_loc, **columns(sloc, "s"),
                    "s_cnt": nus_loc, **{f"pg_{k}": [p[k] for p in s_pagg] for k in AGG_COLS}})
                if fail_after == "local":
                    raise InjectedStageFailure("local")

        # ---- stage 2: the exchange --------------------------------------------------
        if ckpt is not None and ckpt.stage_done("shuffle"):
            b = ckpt.load_stage("shuffle")
            rsh, ssh = batches(b, "r"), batches(b, "s")
            rtot, stot = b["r_cnt"], b["s_cnt"]
            s_px = [tuple(b[f"px_{k}"][j] for k in range(len(AGG_COLS)))
                    for j in range(len(rsh))]
            sh_ovf = int(ckpt.load_scalars("shuffle")["overflow"])
            resumed.append("shuffle")
        else:
            rsh, rtot, ssh, s_px, stot, ovf = _dist_stage_shuffle(
                mesh, rloc, nur_loc, sloc, s_pagg, nus_loc, field, cfg, cap_r, cap_s)
            sh_ovf = ovf[0]
            if ckpt is not None:
                ckpt.save_stage("shuffle", {
                    **columns(rsh, "r"), "r_cnt": rtot, **columns(ssh, "s"), "s_cnt": stot,
                    **{f"px_{k}": [p[k] for p in s_px] for k in range(len(AGG_COLS))}},
                    scalars={"overflow": int(sh_ovf)})
                if fail_after == "shuffle":
                    raise InjectedStageFailure("shuffle")

        # ---- stage 3: the global combine and the joins -----------------------------
        out = _dist_stage_join(mesh, rsh, rtot, ssh, s_px, stot, field, cfg, cap_r, cap_s)
        out["overflow"] = out["overflow"] + sh_ovf
        if ckpt is not None:
            out["resumed_stages"] = resumed
            # the run completed: its checkpoints served their purpose
            ckpt.cleanup()
        return out

    return run
