#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     ``database_technology_algorithms_tpu_torch/csrc`` and time the build;
  2. hold each kernel (K1 view sort, K2 segmented scan, K3 compaction,
     K4 record gather, K5 multi-word sort, K6 adjacent-key equality,
     K7 un-permute) against its plain torch version on the card, bit for
     bit, at the main paths' shapes and at edge cases;
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
     ``distinct`` at 8M and both joins at 16M rows, field 1;
  7. the ``mergejoin``, ``elimdup`` and ``hashjoin`` commands on 100-block
     files written by the port's codec, output files read back;
  8. timings: each kernel's device time (torch.profiler) beside its plain
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
ROWS = 1_000_000
BIG_ROWS = 8 * 1024 * 1024  # 2 * BIG_ROWS == EngineConfig.mem_rows
NBLOCKS = ROWS // 100  # the pipeline command's --nblocks for ROWS rows a table
ROOT = Path(__file__).resolve().parent
STAGED_KERNELS = ("radix_sort", "seg_scan", "compact", "take_fill")
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
    kernel it launched are not counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time / reps
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
    each matched key in u32 key order, with the join output's checksum."""
    col = "recid" if field == 0 else "num"
    r_rows = np.flatnonzero(r["valid"])
    ur, first = np.unique(r[col][r_rows], return_index=True)
    us = np.unique(s[col][s["valid"]])
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
    from database_technology_algorithms_tpu_torch.batch import RecordBatch
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
    one_more = to_batch({k: v[:1] for k, v in s_cols.items()}, dev)

    try:
        make_pipeline_staged(1)(r, RecordBatch.concat([s, one_more]))
    except MemoryBudgetError:
        log("[budget edge] one row over cfg.mem_rows raises MemoryBudgetError")
    else:
        raise AssertionError("over-budget input did not raise MemoryBudgetError")


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


def phase_timings(pipe: dict, command: dict, errs: dict, card: str) -> list[dict]:
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
    errs = check_kernels(dev)
    pipe = phase_pipeline(dev, card)
    command = phase_command(dev, card)
    phase_operators(dev, pipe)
    phase_budget_edge(dev)
    phase_cli()
    kernels = phase_timings(pipe, command, errs, card)
    torch.cuda.synchronize()
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
