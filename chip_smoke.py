#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     ``database_technology_algorithms_tpu_torch/csrc`` and time the build;
  2. hold each kernel (K1 view sort, K2 segmented scan, K3 compaction,
     K4 record gather) against its plain torch version on the card, bit for
     bit, at the main path's shapes and at edge cases;
  3. the main path: ``make_pipeline_staged(1)`` on 1M + 1M generated rows
     (the bench's key range, 3*rows/10), with every launch counter set to 0
     just before and read just after; then field 0.  Counters, join rows and
     the u32 checksum of the join output are held against a numpy oracle
     and against the port's plain path (the same pipeline on the host CPU);
  4. the same at the budget edge, 8M + 8M rows (= cfg.mem_rows);
  5. the ``mergejoin`` CLI entry point on two 100-block files written by
     the port's codec;
  6. timings: each kernel's device time (torch.profiler) beside its plain
     version's, one PyTorch call for the same function (a yardstick only)
     and its memory-bound floor; the pipeline stages with CUDA events, the
     run's host wall time and its device kernel time.

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
ROOT = Path(__file__).resolve().parent
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
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
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
    return result


def phase_budget_edge(dev) -> None:
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.models.pipeline import make_pipeline_staged
    from database_technology_algorithms_tpu_torch.utils.checks import MemoryBudgetError

    r_cols, s_cols = gen_pair(BIG_ROWS)
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    for field in (1, 0):
        run = make_pipeline_staged(field)
        reset_launches()
        out = run(r, s)
        got = check_run(out, oracle(r_cols, s_cols, field), r_cols,
                        f"field {field} {BIG_ROWS}+{BIG_ROWS}")
        if not all(LAUNCHES.values()):
            raise AssertionError(f"budget-edge run missed a kernel: {LAUNCHES}")
        log(f"[budget edge] field {field} {BIG_ROWS}+{BIG_ROWS}: {json.dumps(got)} "
            f"== numpy oracle; host wall per synchronized run "
            f"{wall_ms(lambda: run(r, s), reps=5):.4f} ms")
    one_more = to_batch({k: v[:1] for k, v in s_cols.items()}, dev)
    from database_technology_algorithms_tpu_torch.batch import RecordBatch

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
    shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 6: kernel timings at the main path's shapes


def phase_timings(pipe: dict, errs: dict, card: str) -> list[dict]:
    from database_technology_algorithms_tpu_torch.batch import RecordBatch, as_u32
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
            "replaces": sp["replaces"], "launches": pipe["launches"][sp["name"]],
            "max_abs_err": errs[sp["name"]],
            "ms": device_ms(sp["kernel"]), "plain_ms": device_ms(sp["plain"]),
            "bound_ms": bound_ms(sp["nbytes"]), "bound_by": "bytes",
            "library_ms": device_ms(sp["library"]),
        }
        log(f"[timing] {card}: {sp['name']} ({sp['shape']}): device time per call: "
            f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({sp['nbytes']} B); "
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
    phase_budget_edge(dev)
    phase_cli()
    kernels = phase_timings(pipe, errs, card)
    torch.cuda.synchronize()
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
