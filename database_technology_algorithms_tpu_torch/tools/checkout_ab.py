"""Named sets of calls timed on the card for one or more checkouts of the
repository in turn (say a parent commit unpacked under ``build/`` and this
tree: parent, change, change, parent).

Each checkout runs in a process of its own, with its own package, its own
``chip_smoke.py`` and its own kernel build, and calls public functions whose
arguments are the same in every checkout.  The sets:

- ``tiled_join``: 24M + 24M rows from ``chip_smoke.gen_pair`` (the bench's
  key range), both sides through ``distinct``, then
  ``hash_join_count(s_d, r_d, 1, build_count=nu_s, probe_count=nu_r)``,
  the tiled join of ``make_pipeline_staged(1)`` over the default 16M-row
  budget: the device time of one call (torch.profiler, mean of 5 calls),
  the median host wall of 7 synchronized calls, K9's and K10's share of
  the device time, and nres.
- ``perm``: K6 and K7's scatter on the ``pipeline`` command's R || S (two
  tables of 1M rows from the generator, seeds 42 and 43, ``--nblocks
  10000``): ``adj_equal(words, perm)`` through the keys' sort order (K5's
  perm) with field 2's key (the ``strw`` words) and field 3's (``num``
  beside them), and in place on sorted rows (fields 1, 2 and 3);
  ``unpermute(perm, vals, lo, m)`` from the 2M sorted rows to the 1M probe
  rows' int32 answers and bool flags.  Each call's device time
  (torch.profiler, mean of 10 calls, ``chip_smoke.device_ms``) and a
  checksum of its result.
- ``command``: the ``pipeline`` command's four stages (``distinct`` of
  each table, ``join_sorted_distinct``, ``hash_join``) on the same tables,
  device-resident, by field 0-3: the device time of K6's and K7's kernels
  and of all kernels in a profiled run (mean of 5 runs), and the counters.
- ``copy_range``: K11 at every G of the probe and beside ``copy_`` in
  turns; K22 on one word and on field 3's key, and beside
  ``torch.searchsorted`` in turns.
- ``topk_agg``: K19 on the first shard's sorted probe hashes of the 4-shard
  skew join (``chip_smoke.dist_cols``, 4M + 4M rows, Zipf 1.2 and
  uniform keys), at k = 16, 33 and 1024; K13's wrapper on the inputs of
  ``group_aggregate`` at field 1 over the filtered 16,777,200-row uniform
  and Zipf 1.2 tables (``chip_smoke.agg_table``) and of the two-phase
  combine.  Each call's device time (torch.profiler, mean of 10 calls)
  and its time by kernel and memset, and checksums of the results.
- ``probe``: K15 and K18 on the inputs ``hash_join_count`` gives them at
  field 1 on ``chip_smoke.gen_pair``'s tables of 1M + 1M and 8M + 8M rows
  (under "searchsorted" and "bucketed"), and ``hash_join_count`` itself
  under both engines: each call's device time (torch.profiler, mean of 10
  calls) and its time by launch, and checksums of the results.
- ``hash_hot``: K16 and K17 on the inputs ``hash_join_count`` gives them
  under "table" at field 1 on ``chip_smoke.gen_pair``'s tables of 1M + 1M
  and 8M + 8M rows, ``torch.isin`` of the same probe keys in the build
  keys, and that ``hash_join_count``; K21 on shard 0's build
  and probe hashes of the 4-shard skew join on BASELINE config 4's Zipf
  1.2 tables (4M + 4M, ``chip_smoke.dist_cols``), on shard 0's build
  hashes of the same join on uniform tables, and on a full list
  (``IN_SET_MAX_HOT`` entries, a third live), and the Zipf skew step.
  Each call's device time (torch.profiler, mean of 10 calls) with each
  launch's own in the order they ran, the step's host wall (median of 5),
  and checksums of the results (K16's stored set, flag and failures).
- ``expand_hot``: K14 on the inputs ``materialize_field3_device`` gives it
  at cap = total on ``chip_smoke``'s field-3 join (``field3_join``: 1M +
  1M rows) and on a heavy row (one of 1M probe rows holding all 1M
  outputs), and that ``materialize_field3_device``; K20 as the 4-shard
  skew join on BASELINE config 4's Zipf 1.2 tables (4M + 4M) launches it
  (every call of ``hot_hashes`` or ``hot_lists`` the step makes, each timed
  by launch, summed), and the step itself: its device time, its host wall
  (median of 5) and its kernels in the order they ran, counted by name;
  the hot list's part of the step alone (``hot_list_section_ms``: host
  issue time and wall, medians of 51).  Checksums of the sources, the
  expanded rows, the step's hot list (K21's argument), nres, overflow and
  n_hot.

Printed a line a checkout; the results (checksums, counters, nres) must be
equal across checkouts, or the tool fails.

    python -m database_technology_algorithms_tpu_torch.tools.checkout_ab SET[,SET] ROOT [ROOT ...]
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# kernels of the staging (K9, on either design) and of the build multiplicity
K9_NAMES = ("cells_", "stage_", "onesweep")
K10_NAMES = ("member_mult",)


def tiled_join(cs, dev) -> tuple[dict, dict]:
    import torch

    from database_technology_algorithms_tpu_torch.config import DEFAULT_CONFIG as cfg
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count

    r_cols, s_cols = cs.gen_pair(cs.OVER_ROWS)
    r, s = cs.to_batch(r_cols, dev), cs.to_batch(s_cols, dev)
    r_d, nu_r = distinct(r, 1, cfg, active=r.valid)
    s_d, nu_s = distinct(s, 1, cfg, active=s.valid)
    del r, s

    def join():
        return hash_join_count(s_d, r_d, 1, cfg, build_count=nu_s, probe_count=nu_r)

    _, _, nres = join()
    prof = cs.profile_device(join, reps=5)
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        join()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    share = {"K9": 0.0, "K10": 0.0}
    for name, us in prof["top"]:
        if any(k in name for k in K9_NAMES):
            share["K9"] += us / 1e3
        elif any(k in name for k in K10_NAMES):
            share["K10"] += us / 1e3
    return ({"rows": cs.OVER_ROWS, "device_ms": prof["busy_us"] / 1e3,
             "wall_ms": statistics.median(walls), "walls_ms": walls, "kernels_ms": share},
            {"nres": int(nres)})


def command_tables(cs, dev):
    from database_technology_algorithms_tpu_torch.batch import RecordBatch
    from database_technology_algorithms_tpu_torch.io.generator import generate_columns

    tables = [generate_columns(cs.NBLOCKS, seed=seed) for seed in (42, 43)]
    return [RecordBatch.from_numpy(c["recid"], c["num"], c["strs"], c["valid"], device=dev)
            for c in tables]


def perm(cs, dev) -> tuple[dict, dict]:
    import torch

    from database_technology_algorithms_tpu_torch.batch import RecordBatch
    from database_technology_algorithms_tpu_torch.kernels.adj_equal import adj_equal
    from database_technology_algorithms_tpu_torch.kernels.unpermute import unpermute
    from database_technology_algorithms_tpu_torch.kernels.words_sort import words_sort
    from database_technology_algorithms_tpu_torch.ops.keys import key_words

    both = RecordBatch.concat(command_tables(cs, dev))
    n = both.nrows
    keys = {f"field {f}": key_words(both, f) for f in (2, 3)}
    perms = {f: words_sort(w)[0] for f, w in keys.items()}
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    flags = vals % 3 == 0
    lo = n // 2
    calls = {f"K6 {f} through perm": (lambda w=w, p=perms[f]: adj_equal(w, p))
             for f, w in keys.items()}
    sorted_words = {"field 1": [torch.sort(both.num).values]}
    for f in ("field 2", "field 3"):
        order = perms[f].long()
        strw = both.strw[order]
        lead = [both.num[order].contiguous()] if f == "field 3" else []
        sorted_words[f] = lead + [strw[:, j] for j in range(strw.shape[1])]
    for f, w in sorted_words.items():
        calls[f"K6 {f} in place, sorted"] = lambda w=w: adj_equal(w)
    calls["K7 int32"] = lambda: unpermute(perms["field 2"], vals, lo, n - lo)
    calls["K7 bool"] = lambda: unpermute(perms["field 2"], flags, lo, n - lo)
    ms, sums = {}, {}
    for name, fn in calls.items():
        sums[name] = int(fn().to(torch.int64).sum())
        ms[name] = cs.device_ms(fn)
    return {"rows": n, "ms": ms}, sums


def command(cs, dev) -> tuple[dict, dict]:
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.filter import truncate
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join
    from database_technology_algorithms_tpu_torch.ops.merge_join import join_sorted_distinct

    r, s = command_tables(cs, dev)
    res, counters = {}, {}
    for field in (0, 1, 2, 3):
        def whole(field=field):
            a, na = distinct(r, field)
            b, nb = distinct(s, field)
            _, pairs = join_sorted_distinct(a, na, b, nb, field)
            _, hpairs = hash_join(truncate(a, na), truncate(b, nb), field)
            return na, nb, pairs, hpairs

        counters[f"field {field}"] = [int(x) for x in whole()]
        prof = cs.profile_device(whole, reps=5)
        res[f"field {field}"] = {
            "K6_us": sum(us for name, us in prof["top"] if "adj_equal" in name),
            "K7_us": sum(us for name, us in prof["top"] if "unpermute" in name),
            "busy_us": prof["busy_us"]}
    return res, counters


def copy_range(cs, dev) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from database_technology_algorithms_tpu_torch.kernels.range_dest import range_dest
    from database_technology_algorithms_tpu_torch.kernels.tile_copy import tile_copy
    from database_technology_algorithms_tpu_torch.tools import bench_pallas_dma as dma

    g = np.random.default_rng(15)
    pin = cs.probe_inputs(dev, g)
    x, ms, sums = pin["x"], {}, {}

    def named(prof, name):
        return sum(us for n, us in prof["top"] if name in n) / 1e3

    for G in dma.GS:
        for order, st in pin["starts"].items():
            sums[f"K11 G={G} {order}"] = int(tile_copy(x, st, G).to(torch.int64).sum())
        st = pin["starts"]["identity"]
        ms[f"K11 G={G}"] = named(cs.profile_device(lambda G=G: tile_copy(x, st, G), reps=10),
                                 "tile_copy")
    into = torch.empty_like(x)
    st = pin["starts"]["identity"]
    alt = cs.profile_device(lambda: (tile_copy(x, st, 32), into.copy_(x)), reps=20)
    ms["K11 G=32 in turns"] = named(alt, "tile_copy")
    ms["copy_ in turns"] = sum(us for n, us in alt["top"] if "tile_copy" not in n
                               and "HtoD" not in n and "Memset" not in n) / 1e3
    n = 1 << 20
    num = torch.from_numpy(g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                           .view(np.int32)).to(dev)
    strw = torch.from_numpy(g.integers(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
                            .view(np.int32)).to(dev)
    picks = torch.tensor([n // 4, n // 2, 3 * n // 4], device=dev)
    keys = {"one word": [num], "field 3": [num] + [strw[:, j] for j in range(3)]}
    for what, words in keys.items():
        spl = [w[picks] for w in words]
        sums[f"K22 {what}"] = int(range_dest(words, spl).to(torch.int64).sum())
        ms[f"K22 {what}"] = cs.device_ms(lambda w=words, s=spl: range_dest(w, s))
    words, spl = [num], [num[picks]]
    u64 = lambda t: t.to(torch.int64) & 0xFFFFFFFF  # noqa: E731
    s64, w64 = u64(spl[0]).sort().values, u64(num)
    alt = cs.profile_device(lambda: (range_dest(words, spl),
                                     torch.searchsorted(s64, w64, right=True)), reps=20)
    ms["K22 one word in turns"] = named(alt, "range_dest")
    ms["searchsorted in turns"] = named(alt, "searchsorted")
    ms["K22 one word in turns, all its kernels"] = (
        alt["busy_us"] / 1e3 - ms["searchsorted in turns"])
    return {"ms": ms}, sums


def short_name(name: str) -> str:
    return re.sub(r"^void |[(]anonymous namespace[)]::|dbt::", "", name).split("(")[0]


def topk_agg(cs, dev) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from database_technology_algorithms_tpu_torch.kernels.run_aggregate import run_aggregate
    from database_technology_algorithms_tpu_torch.kernels.topk_runs import topk_runs
    from database_technology_algorithms_tpu_torch.ops import filter as F
    from database_technology_algorithms_tpu_torch.ops.aggregate import group_aggregate
    from database_technology_algorithms_tpu_torch.parallel import dist_ops, skew
    from database_technology_algorithms_tpu_torch.parallel.mesh import make_mesh

    ms, sums = {}, {}

    def timed(what, fn):
        prof = cs.profile_device(fn, reps=10)
        ms[what] = prof["busy_us"] / 1e3
        ms[f"{what}, by kernel"] = {short_name(n): us / 1e3 for n, us in prof["top"]}

    def checksum(tensors):
        return [int((t.to(torch.int64) & 0xFFFFFFFF).sum()) for t in tensors]

    mesh = make_mesh(devices=[dev] * cs.DIST_SHARDS)

    def shards(seed, zipf):  # chip_smoke.phase_dist's tables of BASELINE config 4
        cols = cs.dist_cols(cs.DIST_ROWS, seed, zipf_a=zipf)
        cols["valid"][:] = True
        return dist_ops.distribute(mesh, cols)

    for table, seeds, zipf in (("zipf", (44, 45), 1.2), ("uniform", (46, 47), None)):
        tb, tp = (shards(s, zipf) for s in seeds)
        with cs.recorded_calls("topk_runs", "topk_runs") as calls:
            skew.dist_hash_join_skew(mesh, tb, tp, 1)
        hs, nact, _ = calls[0][0]
        del tb, tp, calls
        for k in (16, 33, 1024):
            what = f"K19 {table} shard, {hs.shape[0]} hashes, k={k}"
            sums[what] = checksum(topk_runs(hs, nact, k))
            timed(what, lambda k=k: topk_runs(hs, nact, k))
    captured = {}
    for table, seed, zipf in (("uniform", 71, None), ("zipf", 72, cs.ZIPF_A)):
        cols = cs.agg_table(cs.AGG_NBLOCKS, seed, zipf)
        t = cs.to_batch(cols, dev)
        live_num = np.sort(cols["num"][cols["valid"]])
        if zipf is None:  # chip_smoke.phase_aggregate's predicates
            lo, hi = int(live_num[len(live_num) // 4]), int(live_num[3 * len(live_num) // 4])
        else:
            lo, hi = 0, int(live_num[len(live_num) // 2]) + 1
        filtered, n_kept = F.filter_batch(t, F.pred_and(F.pred_valid(),
                                                        F.pred_num_range(lo, hi)))
        with cs.recorded_calls("run_aggregate", "run_aggregate") as calls:
            group_aggregate(filtered, 1, count=n_kept)
            cs.two_phase(filtered, n_kept, 1)
        captured[table] = calls[0][0]
        captured[f"{table} combine"] = calls[-1][0]
        del t, filtered, calls
    for what, args in captured.items():
        aggs, ng = run_aggregate(*args)
        what = f"K13 {what}, {args[0].shape[0]} rows, {len(args[2])} measure(s)"
        sums[what] = checksum([aggs[k] for k in cs.AGG_NAMES] + [ng.reshape(1)])
        timed(what, lambda args=args: run_aggregate(*args))
    return {"ms": ms}, sums


def probe(cs, dev) -> tuple[dict, dict]:
    import torch

    from database_technology_algorithms_tpu_torch.kernels.bucket_probe import bucket_probe
    from database_technology_algorithms_tpu_torch.kernels.sorted_probe import sorted_probe
    # bound to the wrappers when first imported: before any recorder swaps one
    from database_technology_algorithms_tpu_torch.ops import bucket_join, fastpath  # noqa: F401
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count

    ms, sums = {}, {}

    def timed(what, fn):
        prof = cs.profile_device(fn, reps=10)
        ms[what] = prof["busy_us"] / 1e3
        ms[f"{what}, by launch"] = {short_name(n): us / 1e3 for n, us in prof["top"]}

    for rows in (cs.ROWS, cs.BIG_ROWS):
        r_cols, s_cols = cs.gen_pair(rows)
        r, s = cs.to_batch(r_cols, dev), cs.to_batch(s_cols, dev)
        for name, engine, wrapper in (("sorted_probe", "searchsorted", sorted_probe),
                                      ("bucket_probe", "bucketed", bucket_probe)):
            cfg = cs.engine_cfg(engine)
            with cs.recorded_calls(name, name) as calls:
                matched, _, nres = hash_join_count(s, r, 1, cfg)
            args = calls[0][0]
            what = f"{rows} + {rows}"
            sums[f"hash_join_count {engine} {what}"] = [int(nres),
                                                       int(matched.to(torch.int64).sum())]
            sums[f"{name} {what}"] = [int(t.to(torch.int64).sum()) for t in wrapper(*args)]
            timed(f"{name} {what}", lambda a=args, w=wrapper: w(*a))
            timed(f"hash_join_count {engine} {what}",
                  lambda c=cfg: hash_join_count(s, r, 1, c))
        del r, s, args, calls
    return {"ms": ms}, sums


def in_order(cs, fn, reps: int = 10) -> list:
    """[name, ms] of each launch of one call of fn, in the order they ran
    (two memsets of one call stay apart), each a mean over the whole calls
    of one profiled window.  Kept here, apart from
    ``chip_smoke.launches_in_order``, because a checkout's ``chip_smoke.py``
    may be older than that function."""
    calls, lost = cs._profile_calls(fn, reps)
    if not calls:
        raise RuntimeError(f"checkout_ab: the trace lost events: {lost}")
    return [[short_name(calls[-1][i].name),
             sum(c[i].device_time for c in calls) / len(calls) / 1e3]
            for i in range(len(calls[0]))]


def hash_hot(cs, dev) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from database_technology_algorithms_tpu_torch.kernels import dist_plan
    from database_technology_algorithms_tpu_torch.kernels.hash_set import (
        hash_set_build, hash_set_probe)
    from database_technology_algorithms_tpu_torch.kernels.hot_set import in_hot_set
    # bound to the wrappers when first imported: before any recorder swaps one
    from database_technology_algorithms_tpu_torch.ops import hash_table  # noqa: F401
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count
    from database_technology_algorithms_tpu_torch.parallel import dist_ops, skew
    from database_technology_algorithms_tpu_torch.parallel.mesh import make_mesh

    ms, sums = {}, {}

    def timed(what, fn):
        launches = in_order(cs, fn)
        ms[what] = sum(t for _, t in launches)
        ms[f"{what}, by launch"] = launches

    def u64sum(t):
        return int((t.to(torch.int64) & 0xFFFFFFFF).sum())

    cfg = cs.engine_cfg("table")
    for rows in (cs.ROWS, cs.BIG_ROWS):
        r_cols, s_cols = cs.gen_pair(rows)
        r, s = cs.to_batch(r_cols, dev), cs.to_batch(s_cols, dev)
        with cs.recorded_calls("hash_set", "hash_set_build") as b, \
                cs.recorded_calls("hash_set", "hash_set_probe") as p:
            matched, _, nres = hash_join_count(s, r, 1, cfg)
        bargs, pargs = b[0][0], p[0][0]
        what = f"{rows} + {rows}"
        hs = hash_set_build(*bargs)
        stored = hs.slots[hs.slots != -1]
        sums[f"K16 {what}"] = [stored.numel(), u64sum(stored), int(hs.has_empty_key),
                               int(hs.n_failed)]
        sums[f"K17 {what}"] = int(hash_set_probe(*pargs)[0].sum())
        sums[f"hash_join_count table {what}"] = [int(nres), int(matched.sum())]
        bkeys, pkeys = bargs[0], pargs[1]
        sums[f"torch.isin {what}"] = int(torch.isin(pkeys, bkeys).sum())
        timed(f"K16 {what}", lambda a=bargs: hash_set_build(*a))
        timed(f"K17 {what}", lambda a=pargs: hash_set_probe(*a))
        timed(f"torch.isin {what}", lambda: torch.isin(pkeys, bkeys))
        timed(f"hash_join_count table {what}", lambda: hash_join_count(s, r, 1, cfg))
        del r, s, b, p, bargs, pargs, hs, stored, bkeys, pkeys
    mesh = make_mesh(devices=[dev] * cs.DIST_SHARDS)
    zb, zp = cs.dist_cols(cs.DIST_ROWS, 44, zipf_a=1.2), cs.dist_cols(cs.DIST_ROWS, 45, zipf_a=1.2)
    zb["valid"][:] = True
    zp["valid"][:] = True
    tb, tp = dist_ops.distribute(mesh, zb), dist_ops.distribute(mesh, zp)

    def step():
        return skew.dist_hash_join_skew(mesh, tb, tp, 1)

    with cs.recorded_calls("hot_set", "in_hot_set") as calls:
        out, nres, ovf, n_hot = step()
    sums["skew step zipf"] = [int(nres), int(ovf), int(n_hot)]
    for i, side in ((0, "build"), (cs.DIST_SHARDS, "probe")):
        hh, hot = calls[i][0]
        what = f"K21 zipf shard 0 {side}, {hh.shape[0]} hashes, {hot.shape[0]} entries"
        sums[what] = int(in_hot_set(hh, hot).sum())
        timed(what, lambda hh=hh, hot=hot: in_hot_set(hh, hot))
    # the same on a uniform shard (no hot key), then a full list, a third of it
    # live, of hashes that occur
    ub, up = cs.dist_cols(cs.DIST_ROWS, 46), cs.dist_cols(cs.DIST_ROWS, 47)
    ub["valid"][:] = True
    up["valid"][:] = True
    tub, tup = dist_ops.distribute(mesh, ub), dist_ops.distribute(mesh, up)
    with cs.recorded_calls("hot_set", "in_hot_set") as ucalls:
        skew.dist_hash_join_skew(mesh, tub, tup, 1)
    uh, uhot = ucalls[0][0]
    what = f"K21 uniform shard 0 build, {uh.shape[0]} hashes, {uhot.shape[0]} entries"
    sums[what] = int(in_hot_set(uh, uhot).sum())
    timed(what, lambda: in_hot_set(uh, uhot))
    del tub, tup, ucalls
    g = np.random.default_rng(18)
    hh = calls[0][0][0]
    full = hh[torch.from_numpy(g.integers(0, hh.shape[0], dist_plan.IN_SET_MAX_HOT)).to(dev)]
    full[torch.from_numpy(g.random(full.shape[0]) < 2 / 3).to(dev)] = -1
    what = f"K21 full list, {hh.shape[0]} hashes, {full.shape[0]} entries"
    sums[what] = int(in_hot_set(hh, full).sum())
    timed(what, lambda: in_hot_set(hh, full))
    del calls
    prof = cs.profile_device(step, reps=5)
    ms["skew step zipf"] = prof["busy_us"] / 1e3
    ms["skew step zipf, in_hot_set"] = sum(us for n, us in prof["top"] if "in_hot_set" in n) / 1e3
    ms["skew step zipf, host wall"] = cs.wall_ms(step, reps=5)
    return {"ms": ms}, sums


def field3_join(cs, dev):
    """(probe, mult, total) of ``chip_smoke.phase_aggregate``'s field-3 join:
    ``generate_f3`` tables of 1M rows (seeds 74 and 75, the build's keys in
    a smaller range), ``hash_join_count`` at field 3."""
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count

    b_cols = cs.generate_f3(cs.AGG_SMALL_NBLOCKS, 74, cs.F3_BUILD_KEYS)
    p_cols = cs.generate_f3(cs.AGG_SMALL_NBLOCKS, 75, cs.F3_PROBE_KEYS)
    build, probe = cs.to_batch(b_cols, dev), cs.to_batch(p_cols, dev)
    _, mult, nres = hash_join_count(build, probe, 3)
    return probe, mult, int(nres)


def expand_hot(cs, dev) -> tuple[dict, dict]:
    import collections
    import importlib

    import torch

    from database_technology_algorithms_tpu_torch.kernels.expand_sources import expand_sources
    from database_technology_algorithms_tpu_torch.ops.hash_join import materialize_field3_device
    from database_technology_algorithms_tpu_torch.parallel import dist_ops, skew
    from database_technology_algorithms_tpu_torch.parallel.mesh import make_mesh

    ms, sums = {}, {}

    def timed(what, fn):
        launches = in_order(cs, fn)
        ms[what] = sum(t for _, t in launches)
        ms[f"{what}, by launch"] = launches

    def u64sum(t):
        return int((t.to(torch.int64) & 0xFFFFFFFF).sum())

    probe, mult, total = field3_join(cs, dev)
    with cs.recorded_calls("expand_sources", "expand_sources") as calls:
        materialize_field3_device(probe, mult, total)
    c, tot, cap = calls[0][0]
    heavy = torch.zeros(c.shape[0], dtype=torch.int32, device=dev)
    heavy[c.shape[0] // 3] = c.shape[0]
    hc = torch.cumsum(heavy, 0, dtype=torch.int32)
    for what, args in ((f"K14 field 3, {c.shape[0]} -> {cap}", (c, tot, cap)),
                       (f"K14 heavy row, {hc.shape[0]} -> {hc.shape[0]}",
                        (hc, hc[-1], hc.shape[0]))):
        sums[what] = u64sum(expand_sources(*args))
        timed(what, lambda a=args: expand_sources(*a))
    out, _ = materialize_field3_device(probe, mult, total)
    what = f"materialize_field3_device, {probe.nrows} probe rows, cap {total}"
    sums[what] = [u64sum(out.recid), u64sum(out.num), u64sum(out.strw), int(out.valid.sum())]
    prof = cs.profile_device(lambda: materialize_field3_device(probe, mult, total), reps=10)
    ms[what] = prof["busy_us"] / 1e3
    ms[f"{what}, by kernel"] = {short_name(n): us / 1e3 for n, us in prof["top"]}
    del probe, mult, out, calls, c, tot, hc, heavy

    mesh = make_mesh(devices=[dev] * cs.DIST_SHARDS)
    zb, zp = cs.dist_cols(cs.DIST_ROWS, 44, zipf_a=1.2), cs.dist_cols(cs.DIST_ROWS, 45, zipf_a=1.2)
    zb["valid"][:] = True
    zp["valid"][:] = True
    tb, tp = dist_ops.distribute(mesh, zb), dist_ops.distribute(mesh, zp)

    def step():
        return skew.dist_hash_join_skew(mesh, tb, tp, 1)

    hot_set = importlib.import_module("database_technology_algorithms_tpu_torch.kernels.hot_set")
    k20 = [n for n in ("hot_lists", "hot_hashes") if hasattr(hot_set, n)]
    with contextlib.ExitStack() as stack:
        rec = {n: stack.enter_context(cs.recorded_calls("hot_set", n)) for n in k20}
        k21 = stack.enter_context(cs.recorded_calls("hot_set", "in_hot_set"))
        _, nres, ovf, n_hot = step()
    sums["skew step zipf"] = [int(nres), int(ovf), int(n_hot), u64sum(k21[0][0][1])]
    k20_calls = [(n, args) for n in k20 for args, _ in rec[n]]
    ms["K20 in the skew step, calls"] = len(k20_calls)
    ms["K20 in the skew step"] = 0.0
    for n, args in k20_calls:
        launches = in_order(cs, lambda f=getattr(hot_set, n), a=args: f(*a))
        ms["K20 in the skew step"] += sum(t for _, t in launches)
    del rec, k21, k20_calls
    prof = cs.profile_device(step, reps=5)
    ms["skew step zipf"] = prof["busy_us"] / 1e3
    ms["skew step zipf, host wall"] = cs.wall_ms(step, reps=5)
    names = [name for name, _ in in_order(cs, step, reps=3)]
    ms["skew step zipf, kernels"] = len(names)
    ms["skew step zipf, kernels by name"] = dict(collections.Counter(names).most_common())
    issue, wall = hot_list_section_ms(skew, hot_set, mesh, tp, tb)
    ms["hot-list section, host issue"] = issue
    ms["hot-list section, host wall"] = wall
    return {"ms": ms}, sums


def hot_list_section_ms(skew, hot_set, mesh, tp, tb, reps: int = 51) -> tuple[float, float]:
    """The hot list's part of ``skew_join_local`` as the checkout's skew
    join runs it, from the shards' key hashes to each shard's hot list and
    n_hot: the medians over `reps` runs of the host's issue time (the device
    idle at its start, no synchronize at its end) and of its synchronized
    wall, in ms.  A checkout with ``skew.gathered_candidates`` reduces both
    sides in one ``hot_lists`` call a device; an older one runs a
    threshold, a ``hot_hash_set``, a ``cat`` and a count a shard."""
    import torch

    from database_technology_algorithms_tpu_torch.config import DEFAULT_CONFIG as cfg
    from database_technology_algorithms_tpu_torch.ops.keys import key_hash

    div = len(mesh.devices) * cfg.hh_factor
    (ph, pa, pc), (bh, ba, bc) = [
        ([key_hash(b, 1) for b in t.batches],
         [torch.arange(b.nrows, device=b.recid.device) < c for b, c in zip(t.batches, t.counts)],
         t.counts) for t in (tp, tb)]

    def section():
        if hasattr(skew, "gathered_candidates"):
            cand_p = skew.gathered_candidates(mesh, ph, pa, cfg.hh_topk)
            cand_b = skew.gathered_candidates(mesh, bh, ba, cfg.hh_topk)
            return mesh.per_device(lambda *a: hot_set.hot_lists(*a, div), *cand_p,
                                   mesh.psum(pc), *cand_b, mesh.psum(bc))
        thr_p = [(t // div).clamp(min=1).to(torch.int32) for t in mesh.psum(pc)]
        hot_p = skew.hot_hash_set(mesh, ph, pa, cfg.hh_topk, thr_p)
        thr_b = [(t // div).clamp(min=1).to(torch.int32) for t in mesh.psum(bc)]
        hot_b = skew.hot_hash_set(mesh, bh, ba, cfg.hh_topk, thr_b)
        hot = [torch.cat([a, b]) for a, b in zip(hot_p, hot_b)]
        return [(h, (h != -1).sum(dtype=torch.int32)) for h in hot]

    issue, wall = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        section()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(issue), statistics.median(wall)


SETS = {"tiled_join": tiled_join, "perm": perm, "command": command, "copy_range": copy_range,
        "topk_agg": topk_agg, "probe": probe, "hash_hot": hash_hot, "expand_hot": expand_hot}


def one(sets: list[str], root: str) -> dict:
    """Run `sets` on the checkout at `root` (in a fresh process whose
    working directory is `root`)."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from database_technology_algorithms_tpu_torch.kernels import build, library

    build()
    library()
    dev = torch.device("cuda")
    out = {"root": root, "sets": {}, "results": {}}
    for name in sets:
        out["sets"][name], out["results"][name] = SETS[name](cs, dev)
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(argv[1].split(","), argv[2])), flush=True)
        return 0
    if len(argv) < 2 or not set(argv[0].split(",")) <= set(SETS):
        print(__doc__)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[checkout_ab] {smi}", flush=True)
    results = None
    for root in argv[1:]:
        # this file, run as a script, imports the checkout's own package
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", argv[0],
                              root], capture_output=True, text=True, cwd=Path(root).resolve())
        lines = out.stdout.strip().splitlines()
        if out.returncode or not lines:
            print(out.stdout[-2000:], out.stderr[-4000:])
            return 1
        got = json.loads(lines[-1])
        if results is not None and got["results"] != results:
            print(f"[checkout_ab] {root}: results differ from the first checkout's: "
                  f"{got['results']} {results}")
            return 1
        results = got["results"]
        print(f"[checkout_ab] {lines[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
