#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     ``database_technology_algorithms_tpu_torch/csrc`` and time the build;
  2. hold each kernel (K1 view sort, K2 segmented scan, K3 compaction,
     K4 record gather, K5 multi-word sort, K6 adjacent-key equality,
     K7 un-permute, K8 key hash, K9 staging into cells, K10 build
     multiplicity over cell pairs) against its plain torch version on the
     card, bit for bit, at the main paths' shapes and at edge cases;
  3. the staged pipeline: ``make_pipeline_staged(1)`` on 1M + 1M generated
     rows (the bench's key range, 3*rows/10), with every launch counter set
     to 0 just before and read just after; then field 0.  Counters, join
     rows and the u32 checksum of the join output are held against a numpy
     oracle and against the port's plain path (the same pipeline on the
     host CPU);
  4. the ``pipeline`` command, the reference's main program, at ``--nblocks 10000``
     (1M + 1M rows) for fields 1, 0, 2, 3, the launch counters set to 0
     before each run and read after it; its JSON counters are held against
     a numpy oracle and against the same command on the host CPU; its stage
     times (CUDA events), host wall and device busy time;
  5. the operators alone at 1M rows: ``distinct``, ``sort_batch`` (against a
     numpy stable sort) and ``hash_join`` on the raw tables (fields 1, 3);
  6. the budget edge: the staged pipeline at 8M + 8M rows (= cfg.mem_rows),
     ``distinct`` at 8M and both joins at 16M rows, field 1; one row over
     the budget routes, and the in-budget cores still raise;
  7. the over-budget route: ``make_pipeline_staged(1)`` on 24M + 24M rows
     under the default budget of 16M (chunked distinct, tiled hash join,
     chunked compaction), the launch counters set to 0 just before and read
     just after, against the numpy oracle; its split into steps and device
     busy time; K8, K9 and K10 held against their plain versions on that
     run's own inputs; the spill copies' rate through pageable and through
     page-locked host memory; ``distinct``, ``sort_batch``, ``hash_join_count`` and
     ``hash_join`` alone at 24M rows; fields 0, 2 and 3 at 1.5M + 1.5M rows
     under a 512K-row budget; all keys equal, where the tiled join overflows,
     retries and still equals numpy;
  8. the ``mergejoin``, ``elimdup`` and ``hashjoin`` commands on 100-block
     files written by the port's codec, output files read back;
  9. timings: each kernel's device time (torch.profiler) beside its plain
     version's, one PyTorch call for the same function where there is one
     (a yardstick only) and its memory-bound floor.

The last two lines of standard output are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1 and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# 32-bit operations outside the tensor cores: the data sheet's float32 rate,
# taken for the integer work of these kernels too
OPS_PER_S = 67e12
PROFILE_GUARD = 1024  # marker kernels ahead of a profiled window
PROFILE_TAIL = 64  # and after it
ROWS = 1_000_000
BIG_ROWS = 8 * 1024 * 1024  # 2 * BIG_ROWS == EngineConfig.mem_rows
NBLOCKS = ROWS // 100  # the pipeline command's --nblocks for ROWS rows a table
ROOT = Path(__file__).resolve().parent
STAGED_KERNELS = ("radix_sort", "seg_scan", "compact", "take_fill")
# what one over-budget run of the staged pipeline must launch
OVERBUDGET_KERNELS = ("hash_words", "stage_cells", "member_mult", "compact", "take_fill",
                      "unpermute")
OVER_ROWS = 24_000_000  # a table; 3x EngineConfig.mem_rows for the pair
MID_ROWS = 1_500_000  # fields 0, 2, 3 under a 512K-row budget
SKEW_ROWS = 200_000  # all keys equal under a 64K-row budget
PKG = "database_technology_algorithms_tpu_torch"
JAX_PKG = "database_technology_algorithms_tpu"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 10) -> float:
    """Median host wall time of fn() followed by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_device(fn, reps: int = 5) -> dict:
    """torch.profiler over `reps` calls: the device kernels' time per call,
    by kernel name (device-side events only, so that an operator and the
    kernel it launched are not counted twice).

    A trace was seen to lose the device events at its start: one event as a
    rule, up to about 300 now and then, never one further in.  So marker
    kernels (an add on a complex128 scalar, which nothing else here launches)
    fence the work: PROFILE_GUARD of them before the first call, one after
    every call, and some more at the end.  Only what follows the first marker
    left in the trace is read, a call at a time, so a call that lost events is
    left out of the mean.  The trace is never taken again: the reading is
    refused where no whole call is left, the calls left differ in their
    number of events, or the trace does not end in a marker."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.zeros(1, dtype=torch.complex128, device="cuda")
    marker.add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_GUARD):
            marker.add_(1)
        for _ in range(reps):
            fn()
            marker.add_(1)
        for _ in range(PROFILE_TAIL):
            marker.add_(1)
        torch.cuda.synchronize()
    events = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                    key=lambda ev: ev.time_range.start)
    calls: list[list] = []  # the events of each call that a marker precedes
    seen_marker, current = False, []
    for ev in events:
        if "complex<double>" in ev.name:
            if seen_marker and current:
                calls.append(current)
            seen_marker, current = True, []
        elif seen_marker:
            current.append(ev)
    if current or not calls or len({len(c) for c in calls}) != 1:
        raise RuntimeError(
            f"torch.profiler lost device events inside the work: {len(events)} events, "
            f"{len(calls)} of {reps} calls whole, with {sorted({len(c) for c in calls})} "
            f"events a call, {len(current)} events after the last marker")
    if len(calls) < reps:
        log(f"[profile] the trace lost its first events: {len(calls)} of {reps} calls are "
            f"whole and are read")
    by_name: dict[str, float] = {}
    for ev in (ev for c in calls for ev in c):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time / len(calls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_us": sum(by_name.values()), "top": top}


def device_ms(fn) -> float:
    """Device time of the kernels one call of fn launches (torch.profiler,
    mean of 10 calls).  Unlike a CUDA-event span over back-to-back calls it
    leaves out the host's issue time, which bounds the small kernels here."""
    us = profile_device(fn, reps=10)["busy_us"]
    if us <= 0:
        raise RuntimeError("torch.profiler reported no device time")
    return us / 1e3


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def bound_of(nbytes: int, nops: int) -> tuple[float, str]:
    """The least time for the work and what bounds it: the larger of the
    bytes over the memory rate and the operations over the 32-bit rate."""
    by_bytes, by_ops = bound_ms(nbytes), nops / OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_abs_err(a, b) -> int:
    """Largest |a - b| over paired tensors (int64 arithmetic); raises on a
    shape mismatch."""
    worst = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            worst = max(worst, int((x.long() - y.long()).abs().max()))
    return worst


def assert_same(what: str, a, b) -> int:
    err = max_abs_err(a, b)
    if err:
        raise AssertionError(f"{what}: kernel and plain version differ (max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# phase 1


def phase_device_and_build() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    from database_technology_algorithms_tpu_torch.kernels import build, library

    t0 = time.time()
    lib_path = build()
    library()
    log(f"[build] {lib_path.name} ready in {time.time() - t0:.1f} s")
    build_log = lib_path.with_suffix(".log")
    if build_log.exists():  # absent when the library was built by an earlier run
        for chunk in build_log.read_text().split("== ")[1:]:
            regs = [int(x) for x in re.findall(r"Used (\d+) registers", chunk)]
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill", chunk)]
            smem = [int(x) for x in re.findall(r"(\d+) bytes smem", chunk)] or [0]
            log(f"[ptxas] {chunk.split()[0]}: {len(regs)} kernels, max {max(regs)} "
                f"registers, max {max(smem)} B static smem, {sum(spills)} B spilled")
    return card


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version


def check_kernels(dev) -> dict:
    from database_technology_algorithms_tpu_torch.kernels.compact import (
        compact_words, compact_words_plain)
    from database_technology_algorithms_tpu_torch.kernels.radix_sort import (
        view_sort, view_sort_plain)
    from database_technology_algorithms_tpu_torch.kernels.seg_scan import (
        seg_scan, seg_scan_plain)
    from database_technology_algorithms_tpu_torch.kernels.take_fill import (
        take_fill, take_fill_plain)

    g = np.random.default_rng(7)

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    def boolean(a):
        return torch.from_numpy(np.asarray(a, dtype=bool)).to(dev)

    errs = {"radix_sort": 0, "seg_scan": 0, "compact": 0, "take_fill": 0}
    sizes = [0, 1, 31, 2049, 4099, 70_001, 2 * ROWS]
    for n in sizes:
        for case in ("mixed", "inactive", "high"):
            lo = 2**31 if case == "high" else 0
            key = i32(g.integers(lo, 2**32, size=n, dtype=np.uint64))
            dup = i32(g.integers(0, max(n // 3, 1), size=n))
            inact = boolean(np.ones(n, bool) if case == "inactive" else g.random(n) < 0.1)
            extra = (i32(g.integers(0, 2**32, size=n, dtype=np.uint64)),)
            for k in (key, dup):
                got = view_sort(inact, k, extra)
                want = view_sort_plain(inact, k, extra)
                errs["radix_sort"] = max(errs["radix_sort"], assert_same(
                    f"K1 n={n} {case}", got[:3] + got[3], want[:3] + want[3]))
            flags = boolean(g.random(n) < 0.3)
            flags_none = boolean(np.zeros(n, bool))
            for op in ("add", "min", "max"):
                for signed in (False, True):
                    for reverse in (False, True):
                        for f in (flags, flags_none, None):
                            got = seg_scan(f, key, op, signed, reverse)
                            want = seg_scan_plain(f, key, op, signed, reverse)
                            errs["seg_scan"] = max(errs["seg_scan"], assert_same(
                                f"K2 n={n} {case} {op} signed={signed} reverse={reverse}",
                                (got,), (want,)))
            keep = inact if case == "inactive" else flags
            got = compact_words(keep, (key, dup, *extra))
            want = compact_words_plain(keep, (key, dup, *extra))
            errs["compact"] = max(errs["compact"], assert_same(
                f"K3 n={n} {case}", (got[0], *got[1]), (want[0], *want[1])))
            for k in (2, 8):
                strw = i32(g.integers(0, 2**32, size=(n, k), dtype=np.uint64))
                valid = boolean(g.random(n) < 0.9)
                m = max(n // 2, 1)
                idx = torch.from_numpy(
                    g.integers(-n - 3, n + 3, size=m).astype(np.int32)).to(dev)
                cols = (key, dup, strw, valid)
                got = take_fill(*cols, idx)
                want = take_fill_plain(*cols, idx)
                errs["take_fill"] = max(errs["take_fill"], assert_same(
                    f"K4 n={n} k={k} {case}", got, want))
    torch.cuda.synchronize()
    log(f"[kernels] K1-K4 equal their plain versions at n in {sizes}")
    errs.update(check_sort_kernels(dev, g, sizes))
    errs.update(check_overbudget_kernels(dev, g, sizes))
    return errs


def check_sort_kernels(dev, g, sizes) -> dict:
    """K5, K6 and K7 against their plain versions on the card."""
    from database_technology_algorithms_tpu_torch.kernels.adj_equal import (
        adj_equal, adj_equal_plain)
    from database_technology_algorithms_tpu_torch.kernels.unpermute import (
        unpermute, unpermute_plain)
    from database_technology_algorithms_tpu_torch.kernels.words_sort import (
        words_sort, words_sort_plain)

    errs = {"words_sort": 0, "adj_equal": 0, "unpermute": 0}
    for n in sizes:
        extra = (torch.from_numpy(g.integers(-2**31, 2**31, size=n).astype(np.int32)).to(dev),)
        for m in (1, 2, 3, 9, 33):
            # columns of one row-major [N, m] matrix (row stride m): few values
            # a column, so ties reach the last word; a third of them >= 2^31
            mat = (g.integers(0, 3, size=(n, m)).astype(np.uint32) << 30) | g.integers(
                0, 2, size=(n, m)).astype(np.uint32)
            mat_t = torch.from_numpy(mat.view(np.int32)).to(dev)
            for case in ("mixed", "inactive", "equal", "no mask"):
                src = torch.zeros_like(mat_t) if case == "equal" else mat_t
                words = [src[:, j] for j in range(m)]
                if case == "mixed" and m == 2:  # contiguous columns as well
                    words = [w.contiguous() for w in words]
                inact = None
                if case != "no mask":
                    inact = torch.from_numpy(
                        np.ones(n, bool) if case == "inactive" else g.random(n) < 0.1).to(dev)
                got = words_sort(words, inact, extra)
                want = words_sort_plain(words, inact, extra)
                errs["words_sort"] = max(errs["words_sort"], assert_same(
                    f"K5 n={n} m={m} {case}", (got[0], got[1], *got[2]),
                    (want[0], want[1], *want[2])))
                for perm in (got[0], None):
                    errs["adj_equal"] = max(errs["adj_equal"], assert_same(
                        f"K6 n={n} m={m} {case} perm={perm is not None}",
                        (adj_equal(words, perm),), (adj_equal_plain(words, perm),)))
        perm = torch.from_numpy(g.permutation(n).astype(np.int32)).to(dev)
        flags = torch.from_numpy(g.random(n) < 0.5).to(dev)
        for lo, m_out in ((0, n), (n // 2, n - n // 2), (n // 3, n // 3), (n, 0)):
            for vals in (extra[0], flags):
                errs["unpermute"] = max(errs["unpermute"], assert_same(
                    f"K7 n={n} lo={lo} m={m_out} {vals.dtype}",
                    (unpermute(perm, vals, lo, m_out),),
                    (unpermute_plain(perm, vals, lo, m_out),)))
    torch.cuda.synchronize()
    log(f"[kernels] K5-K7 equal their plain versions at n in {sizes}: K5 with 1, 2, 3, 9 "
        f"and 33 words (strided columns, words >= 2^31, all rows inactive, all keys equal, "
        f"no mask), K6 through perm and in place, K7 with lo > 0, int32 and bool")
    return errs


def check_overbudget_kernels(dev, g, sizes) -> dict:
    """K8, K9 and K10 against their plain versions on the card."""
    from database_technology_algorithms_tpu_torch.kernels.hash_words import (
        hash_words, hash_words_plain)
    from database_technology_algorithms_tpu_torch.kernels.member_mult import (
        member_multiplicity_cells, member_multiplicity_cells_plain)
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
        stage_to_cells, stage_to_cells_plain, value_boundaries, value_boundaries_plain)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    errs = {"hash_words": 0, "stage_cells": 0, "member_mult": 0}
    for n in sizes:
        # ---- K8: strided columns, words >= 2^31, zero words inside and before
        # the skipped range, two seeds
        for m in (1, 2, 3, 9, 33):
            mat = g.integers(0, 2**32, size=(n, m), dtype=np.uint64).astype(np.uint32)
            mat[g.random((n, m)) < 0.3] = 0
            mat_t = i32(mat)
            words = [mat_t[:, j] for j in range(m)]
            for seed in (0, 1):
                for skip in (None, 0, 1, m):
                    errs["hash_words"] = max(errs["hash_words"], assert_same(
                        f"K8 n={n} m={m} seed={seed} skip={skip}",
                        (hash_words(words, seed, skip),),
                        (hash_words_plain(words, seed, skip),)))
        # ---- K9: destinations at and above nparts, inactive rows, a roomy cap
        # and one that overflows, 1 and 3 payload words (one strided pair)
        pay = i32(g.integers(0, 2**32, size=(n, 2), dtype=np.uint64))
        lone = i32(g.integers(0, 2**32, size=n, dtype=np.uint64))
        active = torch.from_numpy(g.random(n) < 0.9).to(dev)
        for nparts in (2, 16, 4096):
            dest = i32(g.integers(0, nparts + 3, size=n))
            skew = nparts <= 16 and n > 2 * nparts
            if skew:
                dest[: n // 3] = 1  # one cell takes a third of the rows
            even = -(-n // nparts)
            for cap in (max(2 * even, 8) + (n // 3 if skew else 0), max(even // 2, 1)):
                for act in (active, None):
                    for payloads in ([lone], [pay[:, 0], lone, pay[:, 1]]):
                        for row_map in ("slots", "si", "none"):
                            got = stage_to_cells(dest, act, nparts, cap, payloads, row_map)
                            want = stage_to_cells_plain(dest, act, nparts, cap, payloads, row_map)
                            maps = () if row_map == "none" else ((got[2],), (want[2],))
                            errs["stage_cells"] = max(errs["stage_cells"], assert_same(
                                f"K9 n={n} nparts={nparts} cap={cap} active={act is not None} "
                                f"w={len(payloads)} {row_map}",
                                (*got[0], got[1], got[3].reshape(1), *(maps[0] if maps else ())),
                                (*want[0], want[1], want[3].reshape(1), *(maps[1] if maps else ()))))
            for nprobes in (1, nparts + 1, 1025):
                errs["stage_cells"] = max(errs["stage_cells"], assert_same(
                    f"value_boundaries n={n} nprobes={nprobes}",
                    (value_boundaries(dest, nprobes),), (value_boundaries_plain(dest, nprobes),)))
        # ---- K10: G pairs of about 1024 rows a side (the shared-memory table),
        # and the whole n as one pair (beyond 12288 build rows: the table in
        # global scratch); few key values, so build keys repeat; unsorted
        for pairs in sorted({max(n // 1024, 1), 1}):
            cap_b = -(-n // pairs)
            cap_k = cap_b + 8
            for m in (1, 2, 3):
                # both sides draw from one pool of m-word keys (words >= 2^31 too)
                pool = g.integers(0, 2**32, size=(max(cap_b // 3, 2), m), dtype=np.uint64)

                def keys(cap):
                    return i32(pool[g.integers(0, len(pool), size=(pairs, cap))])

                bmat, kmat = keys(cap_b), keys(cap_k)
                bw = [bmat[..., j].contiguous() for j in range(m)]
                kw = [kmat[..., j].contiguous() for j in range(m)]
                nbk = g.integers(0, cap_b + 1, size=pairs)
                nbk[::3] = cap_b
                nbk[1::3] = 0
                nkk = g.integers(0, cap_k + 1, size=pairs)
                nkk[::2] = cap_k
                nbk_t = torch.from_numpy(nbk.astype(np.int32)).to(dev)
                nkk_t = torch.from_numpy(nkk.astype(np.int32)).to(dev)
                live = torch.from_numpy(g.random((pairs, cap_k)) < 0.8).to(dev)
                for nk, lv in ((nkk_t, None), (None, live), (nkk_t, live)):
                    got = member_multiplicity_cells(bw, nbk_t, kw, nk, lv)
                    want = member_multiplicity_cells_plain(bw, nbk_t, kw, nk, lv)
                    errs["member_mult"] = max(errs["member_mult"], assert_same(
                        f"K10 n={n} pairs={pairs} m={m}", (got,), (want,)))
                if n >= 2049 and int(got.max()) < 2:
                    raise AssertionError("K10 check: no build key repeats, the test is too weak")
    torch.cuda.synchronize()
    log(f"[kernels] K8-K10 equal their plain versions at n in {sizes}: K8 with 1, 2, 3, 9 and "
        f"33 strided words, words >= 2^31, zero words in and before the skipped range, seeds 0 "
        f"and 1; K9 with 2, 16 and 4096 cells, the three row maps, inactive rows, destinations "
        f">= nparts, a cap that overflows, 1 and 3 payload words, and value_boundaries on both "
        f"sides of 1024 probes; K10 on batched pairs with 1, 2 and 3 key words, repeated and "
        f"unsorted build keys, n_bkeys of 0 and of cap, dead query rows, tables in shared "
        f"memory and in global scratch")
    return errs


# ---------------------------------------------------------------------------
# phases 3-5: the pipeline


def gen_pair(rows: int, seed: int = 42) -> tuple[dict, dict]:
    """R and S columns: the bench's key range, S's recids offset by half its
    rows so that field 0 matches about half the rows."""
    from database_technology_algorithms_tpu_torch.io.generator import generate_columns

    nblocks = -(-rows // 100)
    key_range = max(3 * rows // 10, 1)
    r = generate_columns(nblocks, seed=seed, key_range=key_range)
    s = generate_columns(nblocks, seed=seed + 1, key_range=key_range,
                         recid_start=rows // 2)
    return ({k: v[:rows] for k, v in r.items()}, {k: v[:rows] for k, v in s.items()})


def to_batch(cols: dict, device):
    from database_technology_algorithms_tpu_torch.batch import RecordBatch

    return RecordBatch.from_numpy(cols["recid"], cols["num"], cols["strs"],
                                  cols["valid"], normalize=False, device=device)


def oracle(r: dict, s: dict, field: int) -> dict:
    """numpy: distinct counts, the intersection, and the first active R row of
    each matched key in key order, with the join output's checksum."""
    kr, ks = key_ids([r, s], field)
    r_rows = np.flatnonzero(r["valid"])
    ur, first = np.unique(kr[r_rows], return_index=True)
    us = np.unique(ks[s["valid"]])
    rows = r_rows[first[np.isin(ur, us, assume_unique=True)]]
    words = np.ascontiguousarray(r["strs"][rows]).view(">u4").astype(np.uint64)
    chk = (r["recid"][rows].astype(np.uint64).sum() + r["num"][rows].astype(np.uint64).sum()
           + words.sum()) % (1 << 32)
    return {"nunique_r": len(ur), "nunique_s": len(us), "merge_nres": len(rows),
            "hash_nres": len(rows), "rows": rows, "chk": int(chk)}


def checksum(batch) -> int:
    from database_technology_algorithms_tpu_torch.batch import as_u32

    total = sum(int(as_u32(c).sum()) for c in (batch.recid, batch.num, batch.strw))
    return total % (1 << 32)


COUNTERS = ("nunique_r", "nunique_s", "merge_nres", "hash_nres")


def check_run(out: dict, want: dict, r_cols: dict, what: str) -> dict:
    got = {k: int(out[k]) for k in COUNTERS}
    for k in COUNTERS:
        if got[k] != want[k]:
            raise AssertionError(f"{what}: {k} = {got[k]}, oracle says {want[k]}")
    if int(out["join_count"]) != want["merge_nres"]:
        raise AssertionError(f"{what}: join_count != merge_nres")
    j = out["join_out"]
    cnt = want["merge_nres"]
    rec = j.recid[:cnt].cpu().numpy().view(np.uint32)
    if not np.array_equal(rec, r_cols["recid"][want["rows"]]):
        raise AssertionError(f"{what}: join rows differ from the oracle's")
    if bool(j.valid[cnt:].any()) or bool(j.recid[cnt:].any()):
        raise AssertionError(f"{what}: rows past the join count are not zero")
    got["chk"] = checksum(j)
    if got["chk"] != want["chk"]:
        raise AssertionError(f"{what}: checksum {got['chk']} != oracle {want['chk']}")
    return got


def phase_pipeline(dev, card: str) -> dict:
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.models.pipeline import make_pipeline_staged

    r_cols, s_cols = gen_pair(ROWS)
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    r_cpu, s_cpu = to_batch(r_cols, "cpu"), to_batch(s_cols, "cpu")
    run1 = make_pipeline_staged(1)
    run1(r, s)  # first call: allocator and module warm-up
    torch.cuda.synchronize()

    # ---- the main path: counts from exactly one run ----------------------
    reset_launches()
    out = run1(r, s)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"[main path] make_pipeline_staged(1) {ROWS}+{ROWS} launches {launches}")
    missing = [k for k in STAGED_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the staged pipeline never launched {missing}")
    result = {"launches": launches}

    for field in (1, 0):
        run = make_pipeline_staged(field)
        got = check_run(run(r, s) if field == 0 else out, oracle(r_cols, s_cols, field),
                        r_cols, f"field {field} {ROWS}+{ROWS}")
        plain = run(r_cpu, s_cpu)
        plain_got = {k: int(plain[k]) for k in COUNTERS}
        plain_got["chk"] = checksum(plain["join_out"])
        if plain_got != got:
            raise AssertionError(f"field {field}: card {got} != plain path {plain_got}")
        log(f"[pipeline] field {field} {ROWS}+{ROWS}: {json.dumps(got)} "
            f"== numpy oracle == plain path")

    # ---- stage times at 1M + 1M -----------------------------------------
    a_out = run1.stage_a(r, s)
    result["stage_a_ms"] = cuda_ms(lambda: run1.stage_a(r, s))
    result["materialize_ms"] = cuda_ms(lambda: run1.materialize(a_out, r, s))
    result["run_ms"] = cuda_ms(lambda: run1(r, s))
    result["run_wall_ms"] = wall_ms(lambda: run1(r, s))
    log(f"[stages] {card}: CUDA events over 20 back-to-back calls: stage_a "
        f"{result['stage_a_ms']:.4f} ms, materialize {result['materialize_ms']:.4f} ms, "
        f"run {result['run_ms']:.4f} ms; host wall per synchronized run "
        f"{result['run_wall_ms']:.4f} ms ({ROWS}+{ROWS} rows, field 1)")
    log(f"[stages] {card}: device kernel time: stage_a "
        f"{device_ms(lambda: run1.stage_a(r, s)):.4f} ms, materialize "
        f"{device_ms(lambda: run1.materialize(a_out, r, s)):.4f} ms")
    prof = profile_device(lambda: run1(r, s))
    if prof["busy_us"] <= 0:
        log("[profile] torch.profiler reported no device time: not measured")
    else:
        share = prof["busy_us"] / (result["run_wall_ms"] * 1e3)
        log(f"[profile] {card}: device kernels {prof['busy_us']:.1f} us per run, "
            f"{len(prof['top'])} kernel names; busy share of the unprofiled host wall "
            f"{share:.3f}")
        for name, us in prof["top"][:14]:
            log(f"[profile]   {us:9.1f} us  {name[:90]}")
    result["inputs"] = (r, s, a_out)
    result["cols"] = (r_cols, s_cols)
    return result


# ---------------------------------------------------------------------------
# phase 4: the ``pipeline`` command (the reference's main program)

COMMAND_COUNTERS = ("nunique_r", "nunique_s", "merge_join_pairs", "hash_join_pairs")
# what each field's run of the command must launch; K1 sorts single-word keys
# under a mask, so the string fields never reach it
COMMAND_KERNELS = {
    0: ("radix_sort", "seg_scan", "compact", "take_fill", "words_sort", "adj_equal", "unpermute"),
    1: ("radix_sort", "seg_scan", "compact", "take_fill", "words_sort", "adj_equal", "unpermute"),
    2: ("seg_scan", "compact", "take_fill", "words_sort", "adj_equal", "unpermute"),
    3: ("seg_scan", "compact", "take_fill", "words_sort", "adj_equal", "unpermute"),
}


def key_ids(cols_list: list[dict], field: int) -> list[np.ndarray]:
    """Each table's key column as integer ids that are equal exactly where
    the keys are equal and ordered as the keys are (u32 order; strings by
    their bytes, which is strcmp order; (num, str) lexicographic)."""
    if field in (0, 1):
        return [c["recid" if field == 0 else "num"].astype(np.int64) for c in cols_list]
    strs = np.concatenate([c["strs"] for c in cols_list])
    width = int(np.flatnonzero(strs.any(axis=0))[-1]) + 1
    raw = np.ascontiguousarray(strs[:, :width])
    if field == 3:
        num = np.concatenate([c["num"] for c in cols_list]).astype(">u4")
        raw = np.ascontiguousarray(np.concatenate([num.view(np.uint8).reshape(-1, 4), raw], axis=1))
    ids = np.unique(raw.view(np.dtype((np.void, raw.shape[1]))).ravel(), return_inverse=True)[1]
    bounds = np.cumsum([0] + [len(c["recid"]) for c in cols_list])
    return [ids[a:b].astype(np.int64) for a, b in zip(bounds[:-1], bounds[1:])]


def command_oracle(r: dict, s: dict, field: int) -> dict:
    kr, ks = key_ids([r, s], field)
    ur, us = np.unique(kr), np.unique(ks)
    pairs = int(np.isin(ur, us, assume_unique=True).sum())
    return {"nunique_r": len(ur), "nunique_s": len(us),
            "merge_join_pairs": pairs, "hash_join_pairs": pairs}


def run_cli(argv: list[str]) -> tuple[int, dict]:
    """One CLI command in this process; returns (exit code, its JSON line)."""
    from database_technology_algorithms_tpu_torch.__main__ import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def phase_command(dev, card: str) -> dict:
    from database_technology_algorithms_tpu_torch.io.generator import generate_columns
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.filter import truncate
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join
    from database_technology_algorithms_tpu_torch.ops.merge_join import join_sorted_distinct

    seed = 42
    r_cols = generate_columns(NBLOCKS, seed=seed)
    s_cols = generate_columns(NBLOCKS, seed=seed + 1)
    base = ["pipeline", "--nblocks", str(NBLOCKS), "--seed", str(seed), "--skip-files"]
    run_cli([*base, "--field", "1"])  # first call: allocator warm-up
    launches = {}
    for field in (1, 0, 2, 3):
        argv = [*base, "--field", str(field)]
        # ---- the main path: counts from exactly one run of the command --------
        reset_launches()
        t0 = time.perf_counter()
        rc, line = run_cli(argv)
        torch.cuda.synchronize()
        cmd_s = time.perf_counter() - t0
        launches[field] = dict(LAUNCHES)
        missing = [k for k in COMMAND_KERNELS[field] if launches[field][k] == 0]
        if missing:
            raise AssertionError(f"pipeline command, field {field}: never launched {missing}")
        if rc != 0 or line["joins_agree"] is not True:
            raise AssertionError(f"pipeline command, field {field}: rc={rc} {line}")
        want = command_oracle(r_cols, s_cols, field)
        got = {k: line[k] for k in COMMAND_COUNTERS}
        if got != want:
            raise AssertionError(f"pipeline command, field {field}: {got}, oracle says {want}")
        rc_cpu, plain = run_cli([*argv, "--device", "cpu"])
        if rc_cpu != 0 or plain != line:
            raise AssertionError(f"field {field}: card {line} != plain path on the CPU {plain}")
        if field == 0 and got["merge_join_pairs"] != ROWS:
            raise AssertionError("field 0: both tables share recids, every row must pair")
        if field == 2 and got["merge_join_pairs"] < 1:
            raise AssertionError("field 2: the planted 'Hola' key must pair")
        log(f"[command] pipeline --nblocks {NBLOCKS} --field {field}: {json.dumps(line)} "
            f"== numpy oracle == plain path; launches {launches[field]}; the command took "
            f"{cmd_s:.2f} s on the host, generation and transfer included")

    # ---- the command's stages, on device-resident tables ----------------------
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    for field in (1, 0, 2, 3):
        def dedup_r():
            return distinct(r, field)

        def dedup_s():
            return distinct(s, field)

        r_d, nu_r = dedup_r()
        s_d, nu_s = dedup_s()
        r_dt, s_dt = truncate(r_d, nu_r), truncate(s_d, nu_s)

        def join():
            return join_sorted_distinct(r_d, nu_r, s_d, nu_s, field)

        def hjoin():
            return hash_join(r_dt, s_dt, field)

        def whole():
            a, na = dedup_r()
            b, nb = dedup_s()
            out = join_sorted_distinct(a, na, b, nb, field)
            return out, hash_join(truncate(a, na), truncate(b, nb), field)

        ms = {name: cuda_ms(fn, reps=10) for name, fn in
              (("distinct_r", dedup_r), ("distinct_s", dedup_s), ("join", join),
               ("hash_join", hjoin))}
        wall = wall_ms(whole, reps=5)
        prof = profile_device(whole, reps=3)
        share = prof["busy_us"] / (wall * 1e3)
        log(f"[command stages] {card}: field {field}, {ROWS}+{ROWS} rows, CUDA events over 10 "
            f"back-to-back calls: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; all four stages, host wall per synchronized run {wall:.4f} ms, device "
            f"kernels {prof['busy_us']:.1f} us per run, busy share {share:.3f}")
        for name, us in prof["top"][:8]:
            log(f"[command profile]   field {field} {us:9.1f} us  {name[:90]}")
    return {"launches": launches, "cols": (r_cols, s_cols), "batches": (r, s)}


# ---------------------------------------------------------------------------
# phase 5: the operators alone


def phase_operators(dev, pipe: dict) -> None:
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import (
        hash_join, hash_join_count)
    from database_technology_algorithms_tpu_torch.ops.sort import is_sorted, sort_batch

    r_cols, s_cols = pipe["cols"]  # the bench's key range: duplicate nums
    r, s, _ = pipe["inputs"]
    for field in (1, 2, 3):
        (kr,) = key_ids([r_cols], field)
        # distinct: the first row of each key, in key order
        uniq, first = np.unique(kr, return_index=True)
        out, nu = distinct(r, field)
        rec = out.recid[: len(uniq)].cpu().numpy().view(np.uint32)
        if int(nu) != len(uniq) or not np.array_equal(rec, r_cols["recid"][first]):
            raise AssertionError(f"distinct field {field}: differs from numpy unique")
        if bool(out.valid[len(uniq):].any()) or bool(out.recid[len(uniq):].any()):
            raise AssertionError(f"distinct field {field}: rows past nunique are not zero")
        # sort_batch: a stable sort by the key
        want_perm = np.argsort(kr, kind="stable")
        sorted_b, perm = sort_batch(r, field)
        if not np.array_equal(perm.cpu().numpy(), want_perm):
            raise AssertionError(f"sort_batch field {field}: perm differs from numpy's stable sort")
        if not bool(is_sorted(sorted_b, field)) or bool(is_sorted(r, field)):
            raise AssertionError(f"sort_batch field {field}: is_sorted is wrong")
        if not np.array_equal(sorted_b.recid.cpu().numpy().view(np.uint32),
                              r_cols["recid"][want_perm]):
            raise AssertionError(f"sort_batch field {field}: rows differ from numpy's")
        log(f"[operators] field {field}, {ROWS} rows: distinct ({len(uniq)} keys) and "
            f"sort_batch equal numpy")
    for field in (1, 3):
        # the raw tables: duplicate keys on both sides
        kb, kp = key_ids([r_cols, s_cols], field)
        counts = np.bincount(kb, minlength=int(max(kb.max(), kp.max())) + 1)
        mult = counts[kp]
        want_n = int(mult.sum()) if field == 3 else int((mult > 0).sum())
        matched, got_mult, nres = hash_join_count(r, s, field)
        if int(nres) != want_n or not np.array_equal(matched.cpu().numpy(), mult > 0):
            raise AssertionError(f"hash_join_count field {field}: nres {int(nres)} != {want_n}")
        if field == 3 and not np.array_equal(got_mult.cpu().numpy(), mult):
            raise AssertionError("hash_join_count field 3: multiplicities differ from numpy's")
        out, nres2 = hash_join(r, s, field)
        hit = int((mult > 0).sum())
        rec = out.recid[:hit].cpu().numpy().view(np.uint32)
        if int(nres2) != want_n or not np.array_equal(rec, s_cols["recid"][mult > 0]):
            raise AssertionError(f"hash_join field {field}: rows differ from numpy's")
        log(f"[operators] hash_join on the raw tables, field {field}: nres {want_n}, "
            f"{hit} probe rows hit, == numpy")


def phase_budget_edge(dev) -> None:
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.models.pipeline import make_pipeline_staged
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count_impl
    from database_technology_algorithms_tpu_torch.utils.checks import MemoryBudgetError

    r_cols, s_cols = gen_pair(BIG_ROWS)
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    for field in (1,):
        run = make_pipeline_staged(field)
        reset_launches()
        out = run(r, s)
        got = check_run(out, oracle(r_cols, s_cols, field), r_cols,
                        f"field {field} {BIG_ROWS}+{BIG_ROWS}")
        if not all(LAUNCHES[k] for k in STAGED_KERNELS):
            raise AssertionError(f"budget-edge run missed a kernel: {LAUNCHES}")
        log(f"[budget edge] field {field} {BIG_ROWS}+{BIG_ROWS}: {json.dumps(got)} "
            f"== numpy oracle; host wall per synchronized run "
            f"{wall_ms(lambda: run(r, s), reps=5):.4f} ms")
    # the operators at the same edge: each distinct sees 8M rows, the merge
    # join of the dedup'd sides and the hash join of the raw tables see 16M
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join
    from database_technology_algorithms_tpu_torch.ops.merge_join import join_sorted_distinct

    want = oracle(r_cols, s_cols, 1)
    r_d, nu_r = distinct(r, 1)
    s_d, nu_s = distinct(s, 1)
    out, nres = join_sorted_distinct(r_d, nu_r, s_d, nu_s, 1)
    got = {"nunique_r": int(nu_r), "nunique_s": int(nu_s), "merge_nres": int(nres)}
    if got != {k: want[k] for k in got}:
        raise AssertionError(f"budget edge operators: {got}, oracle says {want}")
    rec = out.recid[: int(nres)].cpu().numpy().view(np.uint32)
    if not np.array_equal(rec, r_cols["recid"][want["rows"]]):
        raise AssertionError("budget edge join_sorted_distinct: rows differ from the oracle's")
    hit = np.isin(s_cols["num"], r_cols["num"])
    hout, hres = hash_join(r, s, 1)
    hrec = hout.recid[: int(hit.sum())].cpu().numpy().view(np.uint32)
    if int(hres) != int(hit.sum()) or not np.array_equal(hrec, s_cols["recid"][hit]):
        raise AssertionError("budget edge hash_join: differs from numpy")
    log(f"[budget edge] field 1: distinct at {BIG_ROWS} rows, join_sorted_distinct and "
        f"hash_join at {2 * BIG_ROWS}: {json.dumps(got)}, hash nres {int(hres)} == numpy; "
        f"host wall per synchronized call: distinct "
        f"{wall_ms(lambda: distinct(r, 1), reps=3):.4f} ms, join "
        f"{wall_ms(lambda: join_sorted_distinct(r_d, nu_r, s_d, nu_s, 1), reps=3):.4f} ms, "
        f"hash_join {wall_ms(lambda: hash_join(r, s, 1), reps=3):.4f} ms")
    del r_d, s_d, out, hout
    # one row over the budget: the public forms route (each table is in budget,
    # so the distincts run as before and the tiled join takes the 16M + 1 rows);
    # the in-budget cores still refuse
    # the added row repeats S's first, so the oracle's answer stands
    s_over = to_batch({k: np.concatenate([v, v[:1]]) for k, v in s_cols.items()}, dev)
    run = make_pipeline_staged(1)
    reset_launches()
    got = check_run(run(r, s_over), want, r_cols, f"field 1 {BIG_ROWS}+{BIG_ROWS + 1}")
    if not all(LAUNCHES[k] for k in OVERBUDGET_KERNELS):
        raise AssertionError(f"one row over the budget missed a kernel: {LAUNCHES}")
    for what, call in (("stage_a", lambda: run.stage_a(r, s_over)),
                       ("hash_join_count_impl", lambda: hash_join_count_impl(r, s_over, 1))):
        try:
            call()
        except MemoryBudgetError:
            continue
        raise AssertionError(f"{what} took an over-budget input without MemoryBudgetError")
    log(f"[budget edge] one row over cfg.mem_rows routes through the tiled join: "
        f"{json.dumps(got)} == numpy oracle; stage_a and hash_join_count_impl still raise "
        f"MemoryBudgetError")


# ---------------------------------------------------------------------------
# phase 7: the over-budget route


def timed(fn):
    """(result, host wall ms) of one call that ends in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class _CountWarnings:
    """Counts the tiled join's overflow warnings (one per discarded attempt)."""

    def __enter__(self):
        import logging

        self.n = 0
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.n += record.levelno == logging.WARNING

        self.logger = logging.getLogger(f"{PKG}.ops.hash_join")
        self.handler = Handler()
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def check_operators_alone(r, s, r_cols, s_cols, field, cfg, what: str) -> None:
    """distinct, sort_batch, hash_join_count and hash_join on the raw tables
    against numpy."""
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import (
        hash_join, hash_join_count)
    from database_technology_algorithms_tpu_torch.ops.sort import sort_batch

    kb, kp = key_ids([r_cols, s_cols], field)
    uniq, first = np.unique(kb, return_index=True)
    (out, nu), ms_d = timed(lambda: distinct(r, field, cfg))
    rec = out.recid[: len(uniq)].cpu().numpy().view(np.uint32)
    if int(nu) != len(uniq) or not np.array_equal(rec, r_cols["recid"][first]):
        raise AssertionError(f"{what}: distinct differs from numpy unique")
    if bool(out.valid[len(uniq):].any()) or bool(out.recid[len(uniq):].any()):
        raise AssertionError(f"{what}: distinct rows past nunique are not zero")
    del out
    want_perm = np.argsort(kb, kind="stable")
    (sorted_b, perm), ms_s = timed(lambda: sort_batch(r, field, cfg))
    if not np.array_equal(perm.cpu().numpy(), want_perm):
        raise AssertionError(f"{what}: sort_batch perm differs from numpy's stable sort")
    if not np.array_equal(sorted_b.recid.cpu().numpy().view(np.uint32),
                          r_cols["recid"][want_perm]):
        raise AssertionError(f"{what}: sort_batch rows differ from numpy's")
    del sorted_b, perm, want_perm
    counts = np.bincount(kb, minlength=int(max(kb.max(), kp.max())) + 1)
    mult = counts[kp]
    want_n = int(mult.sum()) if field == 3 else int((mult > 0).sum())
    (matched, got_mult, nres), ms_c = timed(lambda: hash_join_count(r, s, field, cfg))
    if int(nres) != want_n or not np.array_equal(matched.cpu().numpy(), mult > 0):
        raise AssertionError(f"{what}: hash_join_count nres {int(nres)} != {want_n}")
    if field == 3:
        if not np.array_equal(got_mult.cpu().numpy(), mult):
            raise AssertionError(f"{what}: hash_join_count multiplicities differ from numpy's")
        if int(mult.max()) < 2:
            raise AssertionError(f"{what}: no build key repeats, mult never exceeds 1")
    (hout, nres2), ms_h = timed(lambda: hash_join(r, s, field, cfg))
    hit = int((mult > 0).sum())
    if int(nres2) != want_n or not np.array_equal(
            hout.recid[:hit].cpu().numpy().view(np.uint32), s_cols["recid"][mult > 0]):
        raise AssertionError(f"{what}: hash_join rows differ from numpy's")
    if bool(hout.valid[hit:].any()):
        raise AssertionError(f"{what}: hash_join rows past the count are not zero")
    log(f"[over budget] {what}: distinct ({len(uniq)} keys), sort_batch, hash_join_count "
        f"(nres {want_n}) and hash_join ({hit} rows) equal numpy; host wall of one "
        f"synchronized call: distinct {ms_d:.1f} ms, sort_batch {ms_s:.1f} ms, hash_join_count "
        f"{ms_c:.1f} ms, hash_join {ms_h:.1f} ms")


def spill_copy_rates(dev, card: str, chunk_rows: int) -> None:
    """One sorted chunk's spill at field 1's shape (the [rows, 2] key matrix
    and the row indices) to the host and back, through pageable and through
    page-locked host memory: the second is what ``ops/chunked.py`` does."""
    mat = torch.zeros((chunk_rows, 2), dtype=torch.int32, device=dev)
    gidx = torch.arange(chunk_rows, dtype=torch.int32, device=dev)
    nbytes = (mat.numel() + gidx.numel()) * 4
    pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (mat, gidx)]
    # a size that no earlier allocation can have left in torch's cache of
    # page-locked blocks (it rounds sizes up to a power of two)
    t0 = time.perf_counter()
    fresh = torch.empty((1 << 28) + 1, dtype=torch.uint8, pin_memory=True)
    alloc_ms = (time.perf_counter() - t0) * 1e3
    del fresh
    pageable = [torch.empty(t.shape, dtype=t.dtype) for t in (mat, gidx)]
    for host in pageable:
        host.zero_()  # touch the pages before the clock starts
    res = {}
    for what, hosts in (("pageable", pageable), ("page-locked", pinned)):
        down = wall_ms(lambda: [h.copy_(t) for h, t in zip(hosts, (mat, gidx))], reps=3)
        up = wall_ms(lambda: [t.copy_(h) for h, t in zip(hosts, (mat, gidx))], reps=3)
        res[what] = (down, up)
    log(f"[spill] {card}: one chunk of {chunk_rows} rows ({nbytes} B), median host wall of 3 "
        f"synchronized copies: pageable to host {res['pageable'][0]:.1f} ms "
        f"({nbytes / res['pageable'][0] / 1e6:.2f} GB/s), back {res['pageable'][1]:.1f} ms "
        f"({nbytes / res['pageable'][1] / 1e6:.2f} GB/s); page-locked to host "
        f"{res['page-locked'][0]:.1f} ms ({nbytes / res['page-locked'][0] / 1e6:.2f} GB/s), back "
        f"{res['page-locked'][1]:.1f} ms ({nbytes / res['page-locked'][1] / 1e6:.2f} GB/s); a "
        f"first page-locked allocation of 512 MiB took {alloc_ms:.1f} ms")


def phase_overbudget(dev, card: str) -> dict:
    from database_technology_algorithms_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.kernels.hash_words import (
        hash_words, hash_words_plain)
    from database_technology_algorithms_tpu_torch.kernels.member_mult import (
        member_multiplicity_cells, member_multiplicity_cells_plain)
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
        stage_to_cells, stage_to_cells_plain)
    from database_technology_algorithms_tpu_torch.models.pipeline import make_pipeline_staged
    from database_technology_algorithms_tpu_torch.ops.chunked import compact_rows_chunked
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import (
        _tile_layout, hash_join_count)
    from database_technology_algorithms_tpu_torch.ops.keys import key_hash

    cfg = DEFAULT_CONFIG
    rows = OVER_ROWS
    t0 = time.perf_counter()
    r_cols, s_cols = gen_pair(rows)
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    torch.cuda.synchronize()
    log(f"[over budget] {rows}+{rows} rows generated and on the card in "
        f"{time.perf_counter() - t0:.1f} s (cfg.mem_rows = {cfg.mem_rows})")
    run = make_pipeline_staged(1)

    # ---- the main path of this route: counts from exactly one run ---------------
    reset_launches()
    out, run_ms = timed(lambda: run(r, s))
    launches = dict(LAUNCHES)
    log(f"[main path] make_pipeline_staged(1) {rows}+{rows} over budget: launches {launches}")
    missing = [k for k in OVERBUDGET_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the over-budget pipeline never launched {missing}")
    got = check_run(out, oracle(r_cols, s_cols, 1), r_cols, f"field 1 {rows}+{rows} over budget")
    del out
    log(f"[over budget] field 1 {rows}+{rows}: {json.dumps(got)} == numpy oracle; host wall "
        f"of the synchronized run {run_ms:.1f} ms")

    # ---- where the time goes: the four steps of the composition -----------------
    (r_d, nu_r), ms_dr = timed(lambda: distinct(r, 1, cfg, active=r.valid))
    (s_d, nu_s), ms_ds = timed(lambda: distinct(s, 1, cfg, active=s.valid))
    (m_r, _, mjn), ms_j = timed(
        lambda: hash_join_count(s_d, r_d, 1, cfg, build_count=nu_s, probe_count=nu_r))
    (_, _), ms_c = timed(lambda: compact_rows_chunked(r_d, m_r, cfg))
    prof = profile_device(lambda: run(r, s), reps=2)
    _, run2_ms = timed(lambda: run(r, s))
    log(f"[over budget] {card}: host wall by step: distinct R {ms_dr:.1f} ms, distinct S "
        f"{ms_ds:.1f} ms, tiled join {ms_j:.1f} ms, chunked compaction {ms_c:.1f} ms; the whole "
        f"run again {run2_ms:.1f} ms; device kernels {prof['busy_us'] / 1e3:.1f} ms per run, "
        f"busy share of that wall {prof['busy_us'] / (run2_ms * 1e3):.3f}")
    for name, us in prof["top"][:12]:
        log(f"[over budget profile]   {us / 1e3:9.3f} ms  {name[:90]}")
    join_prof = profile_device(
        lambda: hash_join_count(s_d, r_d, 1, cfg, build_count=nu_s, probe_count=nu_r), reps=2)
    log(f"[over budget] {card}: the tiled join alone: device kernels "
        f"{join_prof['busy_us'] / 1e3:.1f} ms of its {ms_j:.1f} ms wall")
    for name, us in join_prof["top"][:8]:
        log(f"[tiled join profile]   {us / 1e3:9.3f} ms  {name[:90]}")

    # ---- K8-K10 at this run's shapes: the build side of the tiled join ----------
    ntiles, cap_b, cap_p, group = _tile_layout(rows, rows, cfg.mem_rows)
    b_active = torch.arange(rows, dtype=torch.int32, device=dev) < nu_s
    p_active = torch.arange(rows, dtype=torch.int32, device=dev) < nu_r
    words = [s_d.num]
    hb = key_hash(s_d, 1) & (ntiles - 1)
    hp = key_hash(r_d, 1) & (ntiles - 1)
    # held against the plain versions on this run's inputs: the hash of both
    # sides, both stagings (row maps "none" and "si"), every step's cell pairs
    at_path = {"hash_words": 0, "stage_cells": 0, "member_mult": 0}
    for side, w in (("build", [s_d.num]), ("probe", [r_d.num])):
        at_path["hash_words"] = max(at_path["hash_words"], assert_same(
            f"K8 {rows} {side} rows", (hash_words(w),), (hash_words_plain(w),)))
    bcells, bcnt, _, ovf_b = stage_to_cells(hb, b_active, ntiles, cap_b, words, "none")
    pcells, pcnt, si_p, ovf_p = stage_to_cells(hp, p_active, ntiles, cap_p, [r_d.num], "si")
    want_b = stage_to_cells_plain(hb, b_active, ntiles, cap_b, words, "none")
    want_p = stage_to_cells_plain(hp, p_active, ntiles, cap_p, [r_d.num], "si")
    at_path["stage_cells"] = max(
        assert_same(f"K9 {rows} build rows -> {ntiles} cells of {cap_b}, row map 'none'",
                    (*bcells, bcnt, ovf_b.reshape(1)), (*want_b[0], want_b[1], want_b[3].reshape(1))),
        assert_same(f"K9 {rows} probe rows -> {ntiles} cells of {cap_p}, row map 'si'",
                    (*pcells, pcnt, ovf_p.reshape(1), si_p),
                    (*want_p[0], want_p[1], want_p[3].reshape(1), want_p[2])))
    del want_b, want_p, si_p
    for lo in range(0, ntiles, group):
        cells = ([w.view(ntiles, cap_b)[lo: lo + group] for w in bcells], bcnt[lo: lo + group],
                 [w.view(ntiles, cap_p)[lo: lo + group] for w in pcells], pcnt[lo: lo + group])
        at_path["member_mult"] = max(at_path["member_mult"], assert_same(
            f"K10 pairs {lo} to {lo + group} of {cap_b} + {cap_p} rows",
            (member_multiplicity_cells(*cells),), (member_multiplicity_cells_plain(*cells),)))
    del cells
    log(f"[kernels] K8-K10 equal their plain versions on the over-budget run's inputs: K8 on "
        f"{rows} build and {rows} probe rows, K9 into {ntiles} cells of {cap_b} (row map "
        f"'none') and of {cap_p} ('si'), K10 on all {ntiles // group} steps of {group} pairs")
    bw = [w.view(ntiles, cap_b)[:group] for w in bcells]
    pw = [w.view(ntiles, cap_p)[:group] for w in pcells]
    live_b, live_p = int(bcnt[:group].sum()), int(pcnt[:group].sum())
    nsteps = ntiles // group
    log(f"[over budget] tiling: {ntiles} cells of {cap_b} + {cap_p} rows, {group} pairs a "
        f"step, {nsteps} steps; first step holds {live_b} + {live_p} live rows")
    specs = [
        dict(name="hash_words", source=f"{PKG}/csrc/hash_words.cu",
             replaces=f"{JAX_PKG}/ops/keys.py:110",
             kernel=lambda: hash_words(words), plain=lambda: hash_words_plain(words),
             nbytes=rows * (4 + 4),
             nops=rows * (4 * 3 + 8),  # xor, mask-shift, multiply a byte; the finalizer
             shape=f"{rows} rows, 1 key word (num) -> u32 hash"),
        dict(name="stage_cells", source=f"{PKG}/csrc/stage_cells.cu",
             replaces=f"{JAX_PKG}/ops/movement.py:354",
             kernel=lambda: stage_to_cells(hp, p_active, ntiles, cap_p, [r_d.num], "si"),
             plain=lambda: stage_to_cells_plain(hp, p_active, ntiles, cap_p, [r_d.num], "si"),
             # dest, active and the word read; cells, counts and the row map written
             nbytes=rows * (4 + 1 + 4) + ntiles * cap_p * 4 + ntiles * 4 + rows * 4,
             nops=rows * 8 + ntiles * cap_p,  # bucket, rank and slot a row; a compare a slot
             shape=f"{rows} rows ({int(nu_r)} live) -> {ntiles} cells of {cap_p}, 1 key word, "
                   f"row map 'si'"),
        dict(name="member_mult", source=f"{PKG}/csrc/member_mult.cu",
             replaces=f"{JAX_PKG}/ops/hash_join.py:256",
             kernel=lambda: member_multiplicity_cells(bw, bcnt[:group], pw, pcnt[:group]),
             plain=lambda: member_multiplicity_cells_plain(bw, bcnt[:group], pw, pcnt[:group]),
             # the live rows' key words and the two counts read; every slot's count written
             nbytes=(live_b + live_p) * 4 + group * 8 + group * cap_p * 4,
             # a table hash (20) and about two probes of a compare each a live row
             nops=(live_b + live_p) * 24 + group * cap_p,
             shape=f"{group} pairs of {cap_b} + {cap_p} rows ({live_b} + {live_p} live), "
                   f"1 key word; one of the run's {nsteps} steps"),
    ]
    recs = []
    for sp in specs:
        reps = 2 if sp["name"] == "member_mult" else 3
        least_ms, bound_by = bound_of(sp["nbytes"], sp["nops"])
        rec = {
            "name": sp["name"], "route": "cuda", "source": sp["source"],
            "replaces": sp["replaces"], "launches": launches[sp["name"]],
            "max_abs_err": at_path[sp["name"]], "ms": None,
            "plain_ms": profile_device(sp["plain"], reps=reps)["busy_us"] / 1e3,
            "bound_ms": least_ms, "bound_by": bound_by, "library_ms": None,
        }
        prof = profile_device(sp["kernel"], reps=10)
        rec["ms"] = prof["busy_us"] / 1e3
        log(f"[timing] {card}: {sp['name']} ({sp['shape']}): device time per call: kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library none (no single "
            f"PyTorch call computes it), bound {rec['bound_ms']:.4f} ms by {bound_by} "
            f"({sp['nbytes']} B, {sp['nops']} operations); CUDA-event span per back-to-back "
            f"call: kernel {cuda_ms(sp['kernel'], reps=10):.4f} ms; its largest parts: "
            + ", ".join(f"{re.sub(r'^void |[(]anonymous namespace[)]::|dbt::', '', name).split('(')[0]} "
                        f"{us / 1e3:.4f}" for name, us in prof["top"][:4]))
        recs.append(rec)
    del bcells, pcells, bw, pw, hb, hp, r_d, s_d, m_r
    spill_copy_rates(dev, card, min(cfg.mem_rows, rows))

    # ---- the operators alone at the same size -----------------------------------
    check_operators_alone(r, s, r_cols, s_cols, 1, cfg, f"field 1, {rows} rows a table")
    del r, s, r_cols, s_cols
    torch.cuda.empty_cache()

    # ---- fields 0, 2, 3 on the same route at a smaller depth --------------------
    mid = EngineConfig(mem_rows=1 << 19)
    r_cols, s_cols = gen_pair(MID_ROWS)
    for cols in (r_cols, s_cols):
        cols["strs"][::2, 1:5] = 0  # half the strings one letter: keys repeat and match
        cols["valid"][::37] = False
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    for field in (0, 2, 3):
        reset_launches()
        out = make_pipeline_staged(field, mid)(r, s)
        if not all(LAUNCHES[k] for k in OVERBUDGET_KERNELS):
            raise AssertionError(f"over-budget run, field {field}, missed a kernel: {LAUNCHES}")
        got = check_run(out, oracle(r_cols, s_cols, field), r_cols,
                        f"field {field} {MID_ROWS}+{MID_ROWS} over a budget of {mid.mem_rows}")
        log(f"[over budget] field {field} {MID_ROWS}+{MID_ROWS}, mem_rows {mid.mem_rows}: "
            f"{json.dumps(got)} == numpy oracle")
    check_operators_alone(r, s, r_cols, s_cols, 3, mid,
                          f"field 3, {MID_ROWS} rows a table, mem_rows {mid.mem_rows}")
    del r, s

    # ---- skew: every key equal overflows the cells; the retry ends --------------
    small = EngineConfig(mem_rows=1 << 16)
    r_cols, s_cols = gen_pair(SKEW_ROWS)
    r_cols["num"][:] = 7
    s_cols["num"][:] = 7
    s_cols["num"][::5] = 8
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    ntiles = _tile_layout(SKEW_ROWS, SKEW_ROWS, small.mem_rows)[0]
    with _CountWarnings() as seen:
        matched, _, nres = hash_join_count(r, s, 1, small)
    want = s_cols["num"] == 7
    if int(nres) != int(want.sum()) or not np.array_equal(matched.cpu().numpy(), want):
        raise AssertionError("skewed over-budget hash_join_count differs from numpy")
    if not 0 < seen.n <= ntiles.bit_length() - 1:
        raise AssertionError(f"skewed join: {seen.n} overflow retries, expected 1 to "
                             f"{ntiles.bit_length() - 1}")
    log(f"[over budget] all keys equal, {SKEW_ROWS}+{SKEW_ROWS} rows, mem_rows "
        f"{small.mem_rows}, {ntiles} cells: {seen.n} attempts overflowed and were retried with "
        f"doubled capacity (at most {ntiles.bit_length()} attempts), nres {int(nres)} == numpy")
    return {"launches": launches, "recs": recs}


def phase_cli() -> None:
    from database_technology_algorithms_tpu_torch.__main__ import main as cli
    from database_technology_algorithms_tpu_torch.io.blockfile import (
        read_blockfile_numpy, write_blockfile)

    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    r_cols, s_cols = gen_pair(100 * 100, seed=5)
    f1, f2, fo = (str(work / n) for n in ("file1.bin", "file2.bin", "outmerge.bin"))
    write_blockfile(f1, r_cols)
    write_blockfile(f2, s_cols)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(["mergejoin", f1, f2, fo, "--field", "1"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    want = oracle(r_cols, s_cols, 1)
    back = read_blockfile_numpy(fo)
    if rc != 0 or line["nres"] != want["merge_nres"]:
        raise AssertionError(f"mergejoin CLI: rc={rc} {line} vs oracle {want['merge_nres']}")
    if not np.array_equal(back["recid"], r_cols["recid"][want["rows"]]):
        raise AssertionError("mergejoin CLI: output file rows differ from the oracle's")
    log(f"[cli] mergejoin on 2 x 100 blocks: {json.dumps(line)}; nres and the "
        f"written rows equal the oracle")

    fe, fh = str(work / "outdistinct.bin"), str(work / "outhash.bin")
    for field in (1, 2):
        (kr,) = key_ids([r_cols], field)
        uniq, first = np.unique(kr, return_index=True)
        rc, line = run_cli(["elimdup", f1, fe, "--field", str(field)])
        back = read_blockfile_numpy(fe)
        if rc != 0 or line["nunique"] != len(uniq) or line["rows"] != len(kr):
            raise AssertionError(f"elimdup CLI field {field}: rc={rc} {line} vs {len(uniq)}")
        if not np.array_equal(back["recid"], r_cols["recid"][first]):
            raise AssertionError(f"elimdup CLI field {field}: output rows differ from numpy's")
        log(f"[cli] elimdup field {field} on 100 blocks: {json.dumps(line)}; the written "
            f"rows are the first row of each key, in key order")
    for field in (1, 3):
        kb, kp = key_ids([r_cols, s_cols], field)
        mult = np.bincount(kb, minlength=int(max(kb.max(), kp.max())) + 1)[kp]
        reps = mult if field == 3 else (mult > 0).astype(np.int64)
        rc, line = run_cli(["hashjoin", f1, f2, fh, "--field", str(field)])
        back = read_blockfile_numpy(fh)
        if rc != 0 or line["nres"] != int(reps.sum()) or line["output_order"] != "probe_scan":
            raise AssertionError(f"hashjoin CLI field {field}: rc={rc} {line} vs {int(reps.sum())}")
        if not np.array_equal(back["recid"], np.repeat(s_cols["recid"], reps)):
            raise AssertionError(f"hashjoin CLI field {field}: output rows differ from numpy's")
        log(f"[cli] hashjoin field {field} on 2 x 100 blocks: {json.dumps(line)}; the written "
            f"rows are the probe rows in scan order, repeated per build match for field 3")
    shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 6: kernel timings at the main path's shapes


def phase_timings(pipe: dict, command: dict, over: dict, errs: dict, card: str) -> list[dict]:
    from database_technology_algorithms_tpu_torch.batch import RecordBatch, as_u32
    from database_technology_algorithms_tpu_torch.kernels.adj_equal import (
        adj_equal, adj_equal_plain)
    from database_technology_algorithms_tpu_torch.kernels.unpermute import (
        unpermute, unpermute_plain)
    from database_technology_algorithms_tpu_torch.kernels.words_sort import (
        words_sort, words_sort_plain)
    from database_technology_algorithms_tpu_torch.kernels.compact import (
        compact_words, compact_words_plain)
    from database_technology_algorithms_tpu_torch.kernels.radix_sort import (
        view_sort, view_sort_plain)
    from database_technology_algorithms_tpu_torch.kernels.seg_scan import (
        seg_scan, seg_scan_plain)
    from database_technology_algorithms_tpu_torch.kernels.take_fill import (
        take_fill, take_fill_plain)

    r, s, a_out = pipe["inputs"]
    both = RecordBatch.concat([r, s])
    n, nr, k = both.nrows, r.nrows, r.str_words
    inact, key = ~both.valid, both.num
    perm, matched = a_out["perm"], a_out["matched"]
    # stage A's forward scan: run starts and each run's R head
    s_key = key[perm.long()]
    adj = torch.cat([torch.zeros(1, dtype=torch.bool, device=key.device), s_key[1:] == s_key[:-1]])
    is_start = ~adj
    r_first = ((perm < nr) & ~inact[perm.long()] & is_start).to(torch.int32)
    cnt = int(a_out["cnt"])
    _, (orig_front,) = compact_words(matched, (perm,))
    gather_idx = torch.where(
        torch.arange(nr, dtype=torch.int32, device=key.device) < cnt, orig_front[:nr], n)
    rcols = (r.recid, r.num, r.strw, r.valid)
    rows_packed = torch.cat(
        [r.recid[:, None], r.num[:, None], r.valid.to(torch.int32)[:, None], r.strw], 1)
    clamped = gather_idx.clamp(max=nr - 1)
    composite = (inact.long() << 32) | as_u32(key)

    # K5-K7 at the pipeline command's shapes: field 2 of the generated tables, R||S
    d_r, d_s = command["batches"]
    d_both = RecordBatch.concat([d_r, d_s])
    dn, dk = d_both.nrows, d_both.str_words
    d_words = [d_both.strw[:, j] for j in range(dk)]
    d_inact = torch.zeros(dn, dtype=torch.bool, device=key.device)
    d_inact[::97] = True
    d_perm = words_sort(d_words, d_inact)[0]
    # the u32 words as one order-preserving int64 (sign bit flipped), for the library sort
    wide = ((as_u32(d_words[0]) << 32) | as_u32(d_words[1])) ^ -(1 << 63) if dk == 2 else None
    d_vals = torch.arange(dn, dtype=torch.int32, device=key.device)
    d_perm_long = d_perm.long()

    def library_words_sort():
        order = torch.sort(wide, stable=True).indices
        return order[torch.sort(d_inact[order].to(torch.uint8), stable=True).indices]

    def library_unpermute():
        return torch.empty_like(d_vals).scatter_(0, d_perm_long, d_vals)[d_r.nrows:]

    if wide is None:
        raise AssertionError(f"the generated tables store {dk} string words, expected 2")

    specs = [
        dict(name="radix_sort", source=f"{PKG}/csrc/radix_sort.cu",
             replaces=f"{JAX_PKG}/ops/sort.py:190",
             kernel=lambda: view_sort(inact, key), plain=lambda: view_sort_plain(inact, key),
             library=lambda: torch.sort(composite, stable=True),
             nbytes=n * (4 + 1) + n * (4 + 4 + 1),
             shape=f"{n} rows (inact bool, key u32) -> s_key, perm, s_act"),
        dict(name="seg_scan", source=f"{PKG}/csrc/seg_scan.cu",
             replaces=f"{JAX_PKG}/ops/scan.py:83",
             kernel=lambda: seg_scan(is_start, r_first, "add"),
             plain=lambda: seg_scan_plain(is_start, r_first, "add"),
             library=lambda: torch.cumsum(r_first, 0, dtype=torch.int32),
             nbytes=n * (1 + 4) + n * 4,
             shape=f"{n} rows, segmented add (stage A's run-head carry)"),
        dict(name="compact", source=f"{PKG}/csrc/compact.cu",
             replaces=f"{JAX_PKG}/ops/movement.py:479",
             kernel=lambda: compact_words(matched, (perm,)),
             plain=lambda: compact_words_plain(matched, (perm,)),
             library=lambda: torch.masked_select(perm, matched),
             nbytes=n * (1 + 4) + n * 4 + 4,
             shape=f"{n} rows, 1 payload word (perm), incl. its K2 rank scan"),
        dict(name="take_fill", source=f"{PKG}/csrc/take_fill.cu",
             replaces=f"{JAX_PKG}/batch.py:220",
             kernel=lambda: take_fill(*rcols, gather_idx),
             plain=lambda: take_fill_plain(*rcols, gather_idx),
             library=lambda: torch.index_select(rows_packed, 0, clamped),
             # index read for every output row; source row read only where live
             nbytes=nr * 4 + cnt * (9 + 4 * k) + nr * (9 + 4 * k),
             shape=f"{nr} output rows x (3+{k}) words, {cnt} live"),
        dict(name="words_sort", source=f"{PKG}/csrc/words_sort.cu",
             replaces=f"{JAX_PKG}/ops/sort.py:99",
             kernel=lambda: words_sort(d_words, d_inact),
             plain=lambda: words_sort_plain(d_words, d_inact),
             library=library_words_sort,
             nbytes=dn * (4 * dk + 1) + dn * (4 + 1),
             shape=f"{dn} rows, {dk} string words (columns of strw) + inact -> perm, s_act; "
                   f"library: 2 stable torch.sort passes (int64 key, then inact)",
             launches=command["launches"][2]["words_sort"]),
        dict(name="adj_equal", source=f"{PKG}/csrc/adj_equal.cu",
             replaces=f"{JAX_PKG}/ops/keys.py:68",
             kernel=lambda: adj_equal(d_words, d_perm),
             plain=lambda: adj_equal_plain(d_words, d_perm),
             library=None,  # no single PyTorch call gathers two rows and compares them
             nbytes=dn * (4 + 4 * dk) + dn,
             shape=f"{dn} rows, {dk} key words through perm",
             launches=command["launches"][2]["adj_equal"]),
        dict(name="unpermute", source=f"{PKG}/csrc/unpermute.cu",
             replaces=f"{JAX_PKG}/ops/hash_join.py:242",
             kernel=lambda: unpermute(d_perm, d_vals, d_r.nrows, d_s.nrows),
             plain=lambda: unpermute_plain(d_perm, d_vals, d_r.nrows, d_s.nrows),
             library=library_unpermute,
             nbytes=dn * (4 + 4) + 4 * d_s.nrows,
             shape=f"{dn} sorted rows -> the {d_s.nrows} probe rows' int32 answers (lo = "
                   f"{d_r.nrows}); library: Tensor.scatter_ of all rows, then a slice",
             launches=command["launches"][1]["unpermute"]),
    ]
    extra_scans = {
        "reversed segmented max (any-S suffix)": lambda: seg_scan(
            is_start, r_first, "max", reverse=True),
        "plain add scan (compaction ranks)": lambda: seg_scan(None, r_first, "add"),
    }
    for what, fn in extra_scans.items():
        log(f"[timing] {card}: K2 {what} at {n} rows: device {device_ms(fn):.4f} ms")

    out = []
    for sp in specs:
        rec = {
            "name": sp["name"], "route": "cuda", "source": sp["source"],
            "replaces": sp["replaces"],
            # K1-K4: one run of the staged pipeline; K5-K7: one run of the
            # pipeline command (field 2 for K5 and K6, field 1 for K7)
            "launches": sp.get("launches", pipe["launches"].get(sp["name"])),
            "max_abs_err": errs[sp["name"]],
            "ms": device_ms(sp["kernel"]), "plain_ms": device_ms(sp["plain"]),
            "bound_ms": bound_ms(sp["nbytes"]), "bound_by": "bytes",
            "library_ms": device_ms(sp["library"]) if sp["library"] else None,
            "launches_pipeline_command": {
                f"field {f}": c[sp["name"]] for f, c in command["launches"].items()},
        }
        lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        log(f"[timing] {card}: {sp['name']} ({sp['shape']}): device time per call: "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{lib}, bound {rec['bound_ms']:.4f} ms ({sp['nbytes']} B); "
            f"CUDA-event span per back-to-back call: kernel {cuda_ms(sp['kernel']):.4f} ms")
        out.append(rec)
    # K8-K10 were timed at the over-budget run's shapes while its tables were
    # on the card; their launches are that run's
    for rec in over["recs"]:
        out.append({**rec, "max_abs_err": max(rec["max_abs_err"], errs[rec["name"]])})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    t_start = time.time()
    card = phase_device_and_build()
    marks = [("build", time.time())]

    def done(name: str) -> None:
        torch.cuda.synchronize()
        marks.append((name, time.time()))

    errs = check_kernels(dev)
    done("kernels")
    pipe = phase_pipeline(dev, card)
    done("pipeline")
    command = phase_command(dev, card)
    done("command")
    phase_operators(dev, pipe)
    done("operators")
    phase_budget_edge(dev)
    done("budget edge")
    over = phase_overbudget(dev, card)
    done("over budget")
    phase_cli()
    done("cli")
    kernels = phase_timings(pipe, command, over, errs, card)
    done("timings")
    log("[phases] seconds: " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks[:-1], marks[1:])))
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
