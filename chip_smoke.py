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
     multiplicity over cell pairs, K11 tile copy, K12 row move; K13 run
     aggregate and K14 expansion sources in phase 9, K15-K18 in phase 10,
     K19-K22 in phase 11)
     against its
     plain torch version on the card, bit for bit, at the main paths'
     shapes and at edge cases (K4 and K12, on the row-move engine of
     ``csrc/rowmove.cuh``, also at row widths that take 4-, 8- and 16-byte
     accesses, on views 1-3 words past a 16-byte boundary, at tile edges,
     with every live-count form, and K4 at a 16M-row gather; K2 and K3, on
     the tiles of ``csrc/scan.cuh``, at the tile's edges with every op,
     sign, direction and flag pattern, bool values, 1, 8 and 9 payload
     words with row-index slots, at 16M and 36M rows, and on views 1-3
     elements past a 16-byte boundary, with the kernels and memsets one
     call launches as torch.profiler sees them; K9, count, scan and place
     on ``csrc/stage_cells.cu``, with 1, 2, 16, 4096 and 4097 cells, every
     liveness form (a mask, a live count on the host or the card, both, a
     side 70% inactive), the three row maps, all rows in one cell, the
     count span's edges, "si" with and without the in-range promise and
     the count form against the mask form at 24M rows; K10 with 1, 2, 3
     and 33 key words, the compacted output, skewed pairs and the retry's
     doubled capacities on the global table beside pairs in the shared
     one, and two keys with one 32-bit table hash; K6 at a warp's and a
     block's edges with 1-40 key words in every layout (contiguous,
     strided, 4 bytes past a matrix's start, field 3's num beside strw),
     keys with few values, all equal and all distinct, through the keys'
     sort order, a random perm and in place, up to 2M rows with 9 and 40
     words; K7's scatter at a block's edges, every window, int32 and bool,
     on aligned and shifted views; K7's
     gather with 1-4097 cells, every live-count form and overflowing cells,
     also against the scatter through K9's "si" on the same staging; K1's
     and K5's gather of their extra words, ``gather_words``, packed and
     direct, 1-9 words, rows that end inside a thread's run);
  3. the staged pipeline: ``make_pipeline_staged(1)`` on 1M + 1M generated
     rows (the bench's key range, 3*rows/10), with every launch counter set
     to 0 just before and read just after; then field 0.  Counters, join
     rows and the u32 checksum of the join output are held against a numpy
     oracle and against the port's plain path (the same pipeline on the
     host CPU);
     the placement route: the same pipeline under
     ``EngineConfig(materialize="sort")`` and ``"sort2d"`` for fields 0-3,
     the launch counters set to 0 before each run and read after it,
     against the numpy oracle and column for column against the gather
     route; ``sort_batch``, ``distinct``, ``merge_join``,
     ``join_sorted_distinct``, ``hash_join`` and ``compact_rows`` at 1M
     rows on both placement routes against the gather route; device time
     and host wall of the three routes side by side; the package's
     ``utils/profiling.py`` timers and trace (with an ``annotate`` span) and
     ``utils/roofline.py`` audit on the staged run, and
     ``write_blockfile_native`` against the numpy writer (``[utils]``);
     the probes: the K11 tile copy (``tools/bench_pallas_dma``'s Pallas
     kernel) for each chunk size G (also under plans of other units, rings
     and grids, and at other row widths) and the K12 row move (P4 and P5 of
     ``tools/bench_permute_prims``) through the port's probe modules, with
     their bounds and library yardsticks;
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
     busy time, and the tiled join's device time beside its host wall (it
     must call K9 with the "slots" row map and K7's gather, and launch no
     scatter); K8, K9 (with its phases' times, "slots" and "si"), K10 and
     K7's gather held against their plain versions on that run's own
     inputs, the gather also against the scatter through "si", and K3 on
     every compaction of the route's steps; the
     spill copies' rate through pageable and through
     page-locked host memory; ``distinct``, ``sort_batch``, ``hash_join_count`` and
     ``hash_join`` alone at 24M rows; fields 0, 2 and 3 at 1.5M + 1.5M rows
     under a 512K-row budget; all keys equal, where the tiled join overflows,
     retries and still equals numpy; ``hash_join_count`` at 1M + 1M under
     mem_rows=100, whose 65,536 cells K9 stages in two rounds, against numpy,
     the plain path and each K9 call's plain version; ``gather_words`` (K1's
     and K5's gather of extra words) timed at the route's largest call and
     in ``group_aggregate`` (phase 9) beside ``index_select``;
  8. the ``mergejoin``, ``elimdup`` and ``hashjoin`` commands on 100-block
     files written by the port's codec, output files read back; then the
     external route (``external.py``) through the CLI: ``mergejoin`` and
     ``hashjoin`` of two 9M-row files written by ``generate_pair_files``,
     whose 18M rows pass the 16M-row default budget (the automatic route),
     ``mergesort`` at its default ``--mem-blocks 10000`` and ``elimdup
     --mem-blocks 40000`` at field 1, and all four commands at fields 0, 2
     and 3 on 1M-row files under ``--mem-blocks 1000``; each output file and
     its JSON counters against numpy, ``peak_range_rows <= mem_rows``, an
     empty spill directory and the kernels the run launched, with its host
     wall (a run with no profiler and nothing wrapped) and passes; the
     9M + 9M joins (the automatic route) again under torch.profiler for
     the device busy time and where the wall goes; in that repeat the
     largest ``sort_batch``, ``distinct_sorted`` and ``hash_join_count``
     call runs again on the run's own device batches, every kernel it
     launches held against its plain version; the native block-file library
     built from ``native/dbtio.cpp`` and its read of R against numpy's;
  9. selection filter and group-by aggregate (BASELINE's second
     configuration) at the default budget's edge: two tables of 16,777,200
     rows (uniform keys at the bench's key range, and Zipf 1.2 keys), every
     seventh row's valid flag cleared; ``filter_batch`` (valid and a num
     range keeping about half the live rows), ``group_aggregate`` at field 1
     and the two-phase form (4 slices' local aggregates, then
     ``combine_group_aggregate_impl``), each against numpy (the kept rows;
     the groups' counts, u32 sums, mins, maxes and first rows) and the
     two-phase form against the single pass; fields 0, 2 and 3 at 1M rows;
     ``materialize_field3_device`` on a field-3 join whose multiplicities
     reach tens, at cap = total and total // 2, against the host
     ``materialize_field3``; the launch counters set to 0 before each run
     and read after it, its host wall and device time; K13 and K14 against
     their plain versions at their edges (K14 also at 1M probe rows with one
     row holding every output and with zero runs longer than a merge block)
     and on the runs' own inputs, timed beside their yardsticks, K14 also
     on the heavy row and checked to launch one kernel;
 10. the alternative u32 engines (``EngineConfig.u32_join_engine`` and
     ``u32_distinct_engine``) at the bench's shape: ``hash_join_count`` under
     "generic", "searchsorted" (K15), "table" (K16, K17) and "bucketed"
     (K18) at fields 0 and 1 on 1M + 1M rows, raw and with the dedup'd
     sides' live counts, and field 1 at 8M + 8M; ``hash_join`` under each
     engine at 1M + 1M; ``distinct`` and ``merge_join`` under "fastpath" at
     1M and 16M rows; each against numpy and the generic engine, the launch
     counters set to 0 before each run and read after it, each run's device
     time and host wall beside the generic engine's and ``torch.isin`` of
     the live keys; the forced fallbacks (all build keys equal for
     "bucketed", 100 keys on one home slot for "table") taken once each and
     still exact, and the key whose mix is the table's EMPTY answered
     exactly; K15-K18 against their plain versions at their edges (K15
     also past one index tree's reach, K18 on sparse and all-inactive
     sides, K17 with its fused total under its plan, both windows and
     the evict-first hints on and off, and on tables of 2^24 and 2^25
     slots) and on the 1M runs' own inputs,
     K15-K18 also on the 8M run's, timed there too, each launch alone,
     K17 and K18 beside ``torch.isin`` (``[engines]`` lines);
 11. the distributed plan on a mesh of four shards on the one card
     (``parallel/``, ``make_dist_pipeline``): K19 (top-k runs), K20 (hot
     list; both sides in one launch, in block and grid mode, hot and
     n_hot), K21 (hot-set membership), K22 (range destination: its vector
     path with 0-3 rows of tail, its scalar path on strided and misaligned
     columns) and K9's fill against their plain versions at their edges;
     the plan at 4M + 4M
     rows (1M a shard, every seventh row invalid) for fields 0-3 under the
     "sorted", "skew" and "overlap" engines and "sorted" with 4 exchange
     slices, each run's counters against numpy and the single-card
     pipeline, its join rows' keys against numpy, overflow 0 and the launch
     counters set to 0 before and read after it; BASELINE config 4 (Zipf
     1.2, 4M + 4M): ``dist_hash_join_skew`` (``n_hot`` printed),
     ``dist_hash_join`` and ``dist_hash_join_overlapped`` against numpy, the
     skew join launching K20 once on the one card and its kernels counted
     by name in the order they ran;
     ``dist_sort``, ``dist_distinct`` and ``dist_aggregate`` on 4M rows; a
     3-shard mesh at 3M + 3M (the unsigned modulo); ``pipeline --dist 4``
     on block files under each engine; K19-K22 and K9's fill again on the
     runs' own inputs; a 16M + 16M run's stages (local, shuffle, join)
     timed; the phase must end within 60 s (``[dist]`` lines);
 12. the multi-process plan: ``pipeline --coordinator`` as one process of
     four shards on the card (a process group of one over NCCL; two
     processes cannot share the one card), its ``torch.distributed``
     collectives counted, under the "sorted" and "skew" engines, against
     numpy, the single-card command and ``--dist 4``; then a death after
     the "local" stage checkpointed and a resume that loads it
     (``[multiproc]`` lines);
 13. the forms past the kernels' shared-memory limits, at sizes past the
     real limits, each against its plain version and numpy, with its
     device time and its launches (``[limits]`` lines): K19 at k = 1025 and
     4096 on a Zipf shard, K20 with 32 x 1024 candidates a side, K21 with
     a list of 65,536 entries, K22 with 14,999 splitters of 4 words, the
     shuffle's K9 over 40,000 cells and ``value_boundaries`` over 60,002
     probes (with ``_dest_ranks`` over 60,000 shards), and
     ``member_multiplicity`` over a build of 2^30 + 1 rows; K1 and K5 (2
     strided words) past 2^30 rows, at 2^30 + 65 rows (one digit of a
     scattering pass holding 2^30 + 1 rows) against their plain versions and
     at 2^31 - 1 rows against the stable sort's definition, in chunks;
 14. timings: each kernel's device time (torch.profiler) beside its plain
     version's, one PyTorch call for the same function where there is one
     (a yardstick only) and its memory-bound floor; K1 also at 16M rows
     beside a stable torch.sort, and how many radix passes K1 and K5
     scattered and skipped, as the card chose them; K4 also at the four
     shapes of the ``pipeline`` command (field 2) and at the over-budget
     route's largest gather chunk, as recorded from those paths; K2 also on
     int32 values and at 16M rows beside ``torch.cumsum``, K3 at the
     over-budget route's 16M-row chunk beside ``masked_select``; K6 at the
     over-budget route's largest call and within the ``pipeline`` command's
     profile (fields 0-3), K7's scatter in its bool form on the placement
     route beside ``scatter_``, its gather at the over-budget shape beside
     ``index_select``; K11 and ``copy_`` in turns in one profiled window;
     K22 launching one kernel a call, in turns with
     ``torch.searchsorted(right=True)``, and at field 3's key.

The last two lines of standard output are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits 1 and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PROFILE_GUARD = 1024  # marker kernels ahead of a profiled window
PROFILE_TAIL = 64  # and after it
PROFILE_ATTEMPTS = 3  # traces taken before a reading is refused
ROWS = 1_000_000
BIG_ROWS = 8 * 1024 * 1024  # 2 * BIG_ROWS == EngineConfig.mem_rows
NBLOCKS = ROWS // 100  # the pipeline command's --nblocks for ROWS rows a table
ROOT = Path(__file__).resolve().parent
STAGED_KERNELS = ("radix_sort", "seg_scan", "compact", "take_fill")
# what one over-budget run of the staged pipeline must launch
OVERBUDGET_KERNELS = ("hash_words", "stage_cells", "member_mult", "compact", "take_fill",
                      "unpermute_gather")
OVER_ROWS = 24_000_000  # a table; 3x EngineConfig.mem_rows for the pair
MID_ROWS = 1_500_000  # fields 0, 2, 3 under a 512K-row budget
SKEW_ROWS = 200_000  # all keys equal under a 64K-row budget
PKG = "database_technology_algorithms_tpu_torch"
JAX_PKG = "database_technology_algorithms_tpu"
# the sources that build on the one-sweep radix sort of csrc/radix.cuh and
# on the row-move engine of csrc/rowmove.cuh, and their kernels' names
RADIX_SOURCES = ("radix_sort.cu", "words_sort.cu")
ROWMOVE_SOURCES = ("take_fill.cu", "row_move.cu")
ENGINE_KERNELS = r"onesweep_[a-z]+|take_fill_kernel|row_move_kernel"


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


def profile_device(fn, reps: int = 5, cpu: bool = True) -> dict:
    """torch.profiler over `reps` calls: the device kernels' time per call,
    by kernel name (device-side events only, so that an operator and the
    kernel it launched are not counted twice).

    A trace was seen to lose the device events at its start: one event as a
    rule, up to about 300 now and then; once, all of the work and the end.
    So marker kernels (an add on a complex128 scalar, which nothing else here
    launches) fence the work: PROFILE_GUARD of them before the first call, one
    after every call, and some more at the end.  Only what follows the first
    marker left in the trace is read, a call at a time, so a call that lost
    events is left out of the mean.  A trace with no whole call left, with
    calls that differ in their number of events, or that does not end in a
    marker is thrown away and taken again, up to PROFILE_ATTEMPTS traces in
    all; then the reading is refused.  ``cpu=False`` traces the device
    alone, which keeps the trace of a call with thousands of torch
    operators short to read."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        calls, lost = _profile_calls(fn, reps, cpu)
        if calls:
            break
        log(f"[profile] trace {attempt} of {PROFILE_ATTEMPTS} thrown away: {lost}")
    else:
        raise RuntimeError(f"torch.profiler lost device events inside the work in "
                           f"{PROFILE_ATTEMPTS} traces: {lost}")
    if len(calls) < reps:
        log(f"[profile] the trace lost its first events: {len(calls)} of {reps} calls are "
            f"whole and are read")
    by_name: dict[str, float] = {}
    for ev in (ev for c in calls for ev in c):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time / len(calls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy_us": sum(by_name.values()), "top": top,
            "per_call": [ev.name for ev in calls[-1]]}


def _profile_calls(fn, reps: int, cpu: bool = True) -> tuple[list, str]:
    """One fenced trace of `reps` calls of fn: (the device events of each
    whole call, or [] and what the trace lost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.zeros(1, dtype=torch.complex128, device="cuda")
    marker.add_(1)
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
        return [], (f"{len(events)} events, {len(calls)} of {reps} calls whole, with "
                    f"{sorted({len(c) for c in calls})} events a call, {len(current)} events "
                    f"after the last marker")
    return calls, ""


def device_parts(prof: dict, top: int = 4) -> str:
    """The largest kernels of a profile_device reading, with their ms a call."""
    return ", ".join(f"{launch_name(name)} {us / 1e3:.4f}" for name, us in prof["top"][:top])


def launch_name(name: str) -> str:
    """A device event's name without its namespace and arguments."""
    return re.sub(r"^void |[(]anonymous namespace[)]::|dbt::", "", name).split("(")[0].strip()


def device_ms(fn, cpu: bool = True) -> float:
    """Device time of the kernels one call of fn launches (torch.profiler,
    mean of 10 calls; ``cpu=False`` traces the device alone).  Unlike a
    CUDA-event span over back-to-back calls it leaves out the host's issue
    time, which bounds the small kernels here."""
    us = profile_device(fn, reps=10, cpu=cpu)["busy_us"]
    if us <= 0:
        raise RuntimeError("torch.profiler reported no device time")
    return us / 1e3


@functools.cache
def card_peaks() -> tuple[float, float]:
    """(bytes a second, 32-bit operations a second) of the card, from the
    port's peak table (``utils/roofline.py``), which refuses a card it does
    not list."""
    from database_technology_algorithms_tpu_torch.utils import roofline

    return roofline.chip_hbm_gbps() * 1e9, roofline.chip_ops_per_s()


def bound_ms(nbytes: int) -> float:
    return nbytes / card_peaks()[0] * 1e3


def bound_of(nbytes: int, nops: int) -> tuple[float, str]:
    """The least time for the work and what bounds it: the larger of the
    bytes over the memory rate and the operations over the 32-bit rate."""
    by_bytes, by_ops = bound_ms(nbytes), nops / card_peaks()[1] * 1e3
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
            if chunk.split()[0] in RADIX_SOURCES + ROWMOVE_SOURCES:
                for name, props in ptxas_kernels(chunk).items():
                    if re.match(ENGINE_KERNELS, name):
                        log(f"[ptxas]   {chunk.split()[0]} {name}: {props}")
    return card


def ptxas_kernels(chunk: str) -> dict:
    """Registers, static shared memory and spills of each kernel in one
    source's ``-Xptxas -v`` output, by demangled-enough name."""
    out, name, spill = {}, None, "0 B"
    for line in chunk.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            # _ZN3dbt13onesweep_passILi512ELb1EEEvNS_8PassArgsE -> onesweep_pass<512,1>
            tmpl = re.findall(r"L[ib](\d+)E", raw)
            base = re.search(ENGINE_KERNELS, raw)
            name = (base.group(0) if base else raw) + (f"<{','.join(tmpl)}>" if tmpl else "")
            spill = "0 B"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = f"{m.group(1)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, {m.group(2) or 0} B static smem, {spill} spilled"
    return out


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
    for n, case, key, inact in radix_edge_inputs(g, 1):
        key = i32(np.ascontiguousarray(key[:, 0]))
        extra = (i32(g.integers(0, 2**32, size=n, dtype=np.uint64)),)
        got = view_sort(boolean(inact), key, extra)
        want = view_sort_plain(boolean(inact), key, extra)
        errs["radix_sort"] = max(errs["radix_sort"], assert_same(
            f"K1 n={n} {case}", got[:3] + got[3], want[:3] + want[3]))
    del got, want
    # the budget edge, beyond the 50 MB L2 cache
    n = 2 * BIG_ROWS
    key = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
    inact = torch.rand(n, device=dev, generator=torch.Generator(device=dev).manual_seed(6)) < 0.1
    errs["radix_sort"] = max(errs["radix_sort"], assert_same(
        f"K1 n={n}", view_sort(inact, key)[:3], view_sort_plain(inact, key)[:3]))
    del key, inact
    torch.cuda.synchronize()
    log(f"[kernels] K1-K4 equal their plain versions at n in {sizes}; K1 also at the radix "
        f"tile's edges and {2 * ROWS} rows ({RADIX_EDGE_CASES}) and at {n} rows")
    errs["take_fill"] = max(errs["take_fill"], check_take_fill_cases(dev, g))
    for name, err in check_scan_compact_cases(dev, g).items():
        errs[name] = max(errs[name], err)
    errs.update(check_sort_kernels(dev, g, sizes))
    gather_err = check_gather_words_cases(dev, g)
    for name in ("radix_sort", "words_sort"):
        errs[name] = max(errs[name], gather_err)
    errs["adj_equal"] = max(errs["adj_equal"], check_adj_cases(dev, g))
    errs["unpermute"] = max(errs["unpermute"], check_unpermute_cases(dev, g))
    errs["unpermute_gather"] = check_gather_cases(dev, g)
    errs.update(check_overbudget_kernels(dev, g, sizes))
    errs.update(check_probe_kernels(dev, g, sizes[:4] + sizes[5:]))
    return errs


SCAN_FLAG_CASES = ("random", "tile first row", "tile last row", "no row", "one run", "None")
KEEP_CASES = ("random", "all", "none", "alternating")
BEYOND_L2_ROWS = (16 * 1024 * 1024, 36_000_000)  # the over-budget chunk; the tiled join's slots


def scan_flags(g, n: int, case: str, tile: int, dev):
    """Run starts of one K2 edge case (tests/test_torch_scan_schedule.py's)."""
    rows = np.arange(n)
    f = {"random": g.random(n) < 0.2, "tile first row": rows % tile == 0,
         "tile last row": (rows % tile == tile - 1) | (rows == n - 1),
         "no row": np.zeros(n, bool), "one run": rows == 0, "None": None}[case]
    return None if f is None else torch.from_numpy(f).to(dev)


def keep_mask(g, n: int, case: str, dev):
    k = {"random": g.random(n) < 0.4, "all": np.ones(n, bool), "none": np.zeros(n, bool),
         "alternating": np.arange(n) % 2 == 0}[case]
    return torch.from_numpy(k).to(dev)


def check_scan_compact_cases(dev, g) -> dict:
    """K2 and K3 against their plain versions at the edges of their tiles
    (kernels/scan_plan.py): the CPU tests' cases at the plan's tile (flags on
    every tile's first or last row, on none, one run across every tile, no
    flags; add, min and max, signed and unsigned, reversed; bool values;
    keep all, none, alternating; 1, 8 and 9 payload words with row-index
    slots); beyond the 50 MB L2 at 16M and 36M rows; views that start 1-3
    elements past a 16-byte boundary; and the launches of one call of each
    as torch.profiler sees them."""
    from database_technology_algorithms_tpu_torch.kernels import scan_plan
    from database_technology_algorithms_tpu_torch.kernels.compact import (
        compact_words, compact_words_plain)
    from database_technology_algorithms_tpu_torch.kernels.seg_scan import (
        seg_scan, seg_scan_plain)

    def words(n):
        return torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(n))

    errs = {"seg_scan": 0, "compact": 0}

    def scan_same(what, f, v, op="add", signed=False, reverse=False):
        errs["seg_scan"] = max(errs["seg_scan"], assert_same(
            f"K2 {what} {op} signed={signed} reverse={reverse}",
            (seg_scan(f, v, op, signed, reverse),), (seg_scan_plain(f, v, op, signed, reverse),)))

    def compact_same(what, keep, payload):
        got, want = compact_words(keep, payload), compact_words_plain(keep, payload)
        if got[0].dim() != 0 or got[0].device != keep.device or got[0].dtype != torch.int32:
            raise AssertionError(f"K3 {what}: the count is not a 0-d int32 tensor on the card")
        errs["compact"] = max(errs["compact"], assert_same(
            f"K3 {what}", (got[0], *got[1]), (want[0], *want[1])))

    t = scan_plan.TILE
    sizes = [0, 1, t - 1, t, t + 1, 3 * t + 5, 37 * t + 3]
    for n in sizes:
        v = words(n)
        bools = torch.from_numpy(g.random(n) < 0.4).to(dev)
        for case in SCAN_FLAG_CASES:
            f = scan_flags(g, n, case, t, dev)
            for op in ("add", "min", "max"):
                for signed in (False, True):
                    for reverse in (False, True):
                        scan_same(f"n={n} flags {case}", f, v, op, signed, reverse)
                        scan_same(f"n={n} flags {case} bool values", f, bools, op, signed, reverse)
        for case in KEEP_CASES:
            keep = keep_mask(g, n, case, dev)
            for nwords in (1, 8, 9):
                payload = [words(n + 1 + j)[:n] for j in range(nwords)]
                if nwords > 1:
                    payload[1] = 0  # the row index
                if nwords > 8:
                    payload[8] = 1000  # the row index from 1000
                compact_same(f"n={n} keep {case} {nwords} words", keep, tuple(payload))
    torch.cuda.synchronize()
    # beyond L2
    for n in BEYOND_L2_ROWS:
        v = words(n)
        f = torch.rand(n, device=dev, generator=torch.Generator(device=dev).manual_seed(3)) < 0.3
        scan_same(f"n={n}", f, v)
        scan_same(f"n={n}", f, v, "max", False, True)
        scan_same(f"n={n} no flags, bool values", None, f)
        compact_same(f"n={n} random keep, a word and the row index", f, (v, 0))
        del v, f
    torch.cuda.synchronize()
    # views 1-3 elements past a 16-byte boundary: the 16-byte loads take
    # narrower accesses there
    n = 5 * t + 7
    for off_f, off_v in ((1, 1), (2, 3), (3, 2), (0, 1), (1, 0)):
        fb = torch.from_numpy(g.random(n + 16) < 0.2).to(dev)[off_f: off_f + n]
        vw = unaligned(words(n), off_v)
        bb = torch.from_numpy(g.random(n + 16) < 0.5).to(dev)[off_v: off_v + n]
        for reverse in (False, True):
            scan_same(f"n={n} views at {off_f}, {off_v}", fb, vw, "min", True, reverse)
            scan_same(f"n={n} views at {off_f}, {off_v}, bool values", fb, bb, "add", False,
                      reverse)
        compact_same(f"n={n} views at {off_f}, {off_v}", fb, (vw, 5, unaligned(words(n), 3)))
    torch.cuda.synchronize()
    log(f"[kernels] K2 and K3 equal their plain versions at the tile's edges, n in {sizes} "
        f"(flags {SCAN_FLAG_CASES}; add, min, max, signed and not, reversed, u32 and bool "
        f"values; keep {KEEP_CASES} with 1, 8 and 9 words and row-index slots), at "
        f"{BEYOND_L2_ROWS} rows, and on views 1-3 elements past a 16-byte boundary")
    # the launches of one call, as torch.profiler sees them
    n = 2 * ROWS
    v = words(n)
    f = torch.rand(n, device=dev, generator=torch.Generator(device=dev).manual_seed(4)) < 0.3
    for name, fn, kernels in (("K2", lambda: seg_scan(f, v), 1),
                              ("K3", lambda: compact_words(f, (v,)), 2),
                              ("K3, 9 words", lambda: compact_words(f, (v,) * 9), 3)):
        events = profile_device(fn, reps=3)["per_call"]
        nkern = sum("memset" not in e.lower() for e in events)
        nmem = len(events) - nkern
        log(f"[launches] {name}, one call at {n} rows: {nkern} kernels and {nmem} memsets "
            f"({', '.join(events)})")
        if nkern != kernels or nmem > 1:
            raise AssertionError(f"{name}: {nkern} kernels and {nmem} memsets a call, expected "
                                 f"{kernels} and at most 1")
    return errs


RADIX_EDGE_CASES = ("equal", "one run", "equal, flag varies", "constant digits", "all inactive")
TAKE_WIDTHS = (1, 2, 3, 4, 8, 30)  # K4's string words: 4-, 8- and 16-byte accesses
MOVE_WIDTHS = (1, 3, 5, 36)  # K12's row widths
GATHER_CHUNK = 16 * 1024 * 1024  # the over-budget route's largest K4 gather (cfg.mem_rows)


def unaligned(t: torch.Tensor, words: int) -> torch.Tensor:
    """`t` copied into a contiguous view `words` 4-byte words past the start
    of a larger buffer, as a row slice of a batch or a chunk of an index is."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = flat[words: words + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def live_counts(dev, m: int) -> dict:
    """The count forms K4 and K12 (load) take: none, a 0-d int32 tensor on
    the card, a host integer; at none, some, all, past all and below zero."""
    def on_card(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    return {"none": None, "card m/3": on_card(m // 3), "host m/2": m // 2, "card 0": on_card(0),
            "card m+5": on_card(m + 5), "card -1": on_card(-1)}


def check_take_fill_cases(dev, g) -> int:
    """K4 against its plain version at the row-move engine's edges: string
    widths K of 1, 2, 3, 4, 8 and 30 words, the string words 1 to 3 words
    past a 16-byte boundary and a row slice of every column (unaligned
    views), indices all out of range, an empty source, every live-count
    form, and one gather of GATHER_CHUNK rows (the over-budget route's
    chunk) from 24M rows."""
    from database_technology_algorithms_tpu_torch.kernels.take_fill import (
        take_fill, take_fill_plain)

    def columns(n, k):
        return (torch.from_numpy(g.integers(-2**31, 2**31, size=n).astype(np.int32)).to(dev),
                torch.from_numpy(g.integers(-2**31, 2**31, size=n).astype(np.int32)).to(dev),
                torch.from_numpy(g.integers(-2**31, 2**31, size=(n, k)).astype(np.int32)).to(dev),
                torch.from_numpy(g.random(n) < 0.9).to(dev))

    def check(what, cols, idx, count):
        return assert_same(f"K4 {what}", take_fill(*cols, idx, count),
                           take_fill_plain(*cols, idx, count))

    err, calls = 0, 0
    n, m = 70_001, 50_003
    for k in TAKE_WIDTHS:
        cols = columns(n, k)
        idx = torch.from_numpy(g.integers(-n - 3, n + 3, size=m).astype(np.int32)).to(dev)
        cases = {"aligned": (cols, idx),
                 "row slice": (tuple(c[1:] for c in cols), idx[1:]),
                 "all fill": (cols, torch.where(idx < 0, -n - 1, n).to(torch.int32)),
                 "empty source": (tuple(c[:0] for c in cols), idx)}
        for words in (1, 2, 3):
            cases[f"strw {words} words past 16 B"] = ((*cols[:2], unaligned(cols[2], words),
                                                       cols[3]), unaligned(idx, words))
        for what, (c, i) in cases.items():
            for form, count in live_counts(dev, i.shape[0]).items():
                err = max(err, check(f"n={c[0].shape[0]} m={i.shape[0]} K={k} {what}, count "
                                     f"{form}", c, i, count))
                calls += 1
    # beyond the 50 MB L2 (the plan's small spans): the over-budget route's
    # chunk, a 16M-row gather from 24M rows with K = 2, and 4M rows with K = 3
    for big_n, big_m, k in ((OVER_ROWS, GATHER_CHUNK, 2), (4_000_000, 4_000_000, 3)):
        cols = columns(big_n, k)
        idx = torch.randint(-big_n // 10, big_n + big_n // 10, (big_m,), dtype=torch.int32,
                            device=dev, generator=torch.Generator(device=dev).manual_seed(12))
        for form, count in (("none", None),
                            ("card", torch.tensor(big_m - 12345, dtype=torch.int32, device=dev))):
            err = max(err, check(f"n={big_n} m={big_m} K={k}, count {form}", cols, idx, count))
            calls += 1
        del cols, idx
    torch.cuda.synchronize()
    log(f"[kernels] K4 equals its plain version in {calls} more calls: K in {TAKE_WIDTHS} at "
        f"n={n}, m={m}, aligned, as a row slice, with the string words 1-3 words past 16 B, all "
        f"fill and from an empty source, each with the live count {list(live_counts(dev, 1))}; "
        f"and beyond L2 a {GATHER_CHUNK}-row gather from {OVER_ROWS} rows (K=2) and 4M rows "
        f"(K=3)")
    return err


def radix_edge_inputs(g, m: int):
    """The cases that only the one-sweep radix sort (csrc/radix.cuh) can get
    wrong, as (n, case, u32 keys [n, m], inactive mask): n at the edges of
    its 4096-row tile and at 2M rows; all keys equal (every pass trivial,
    the input copied through); one digit run across every tile with a few
    other keys (the look-back carries it from tile to tile); equal keys with
    a varying flag (only the flag's pass scatters); digits 1 and 3 of every
    word constant (those passes skipped); every row inactive."""
    from database_technology_algorithms_tpu_torch.kernels.radix_plan import TILE

    for n in (TILE - 1, TILE, TILE + 1, 2 * TILE + 1, 2 * ROWS):
        for case in RADIX_EDGE_CASES:
            key = np.full((n, m), 0x2A2A2A2A, np.uint32)
            inact = np.zeros(n, bool)
            if case == "one run":
                key[::4099] = g.integers(0, 2**32, size=key[::4099].shape, dtype=np.uint64)
            elif case == "equal, flag varies":
                inact = g.random(n) < 0.1
            elif case == "constant digits":
                key = (g.integers(0, 2**32, size=(n, m), dtype=np.uint64).astype(np.uint32)
                       & np.uint32(0x00FF00FF)) | np.uint32(0x5A003C00)
            elif case == "all inactive":
                key = g.integers(0, 2**32, size=(n, m), dtype=np.uint64).astype(np.uint32)
                inact = np.ones(n, bool)
            yield n, case, key, inact


def probe_inputs(dev, g) -> dict:
    """The probes' own inputs: K11's [n*32/128, 128] words with identity and
    tile-permuted starts (on the host, as the TPU's scalar prefetch takes
    them), K12's [N, 36] words with one random slot permutation a tile."""
    from database_technology_algorithms_tpu_torch.tools import bench_pallas_dma as dma
    from database_technology_algorithms_tpu_torch.tools import bench_permute_prims as prims

    n, tiles = dma.N, dma.N // dma.T
    x = torch.from_numpy(g.integers(0, 2**32, size=(n * dma.W // 128, 128), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).to(dev)
    starts = {"identity": torch.arange(tiles, dtype=torch.int32) * dma.T,
              "tile-permuted": torch.from_numpy(g.permutation(tiles).astype(np.int32)) * dma.T}
    rows = torch.from_numpy(g.integers(0, 2**32, size=(prims.N, prims.W), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    slot = torch.from_numpy(prims.tile_slots(prims.N, prims.T)).to(dev)
    return {"x": x, "starts": starts, "rows": rows, "slot": slot}


def check_probe_kernels(dev, g, sizes) -> dict:
    """K11 and K12 against their plain versions on the card: K11 for every G
    of the probe with identity and tile-permuted starts; K12 in both modes at
    the probe's tiles and as one tile spanning all rows (the placement
    route's form) with slots outside the tile."""
    from database_technology_algorithms_tpu_torch.kernels.row_move import (
        row_move, row_move_plain)
    from database_technology_algorithms_tpu_torch.kernels.tile_copy import (
        tile_copy, tile_copy_plain)
    from database_technology_algorithms_tpu_torch.tools import bench_pallas_dma as dma
    from database_technology_algorithms_tpu_torch.tools import copy_sweep
    from database_technology_algorithms_tpu_torch.tools import bench_permute_prims as prims

    errs = {"tile_copy": 0, "row_move": 0}
    pin = probe_inputs(dev, g)
    # the default plan, and plans whose blocks take tens of units through their ring,
    # with units of 32-512 rows (chunks that span units) and rings of 2-16
    plans = ({"UNIT_BYTES": 64 * 128, "RING": 8, "BLOCKS_PER_SM": 1},
             {"UNIT_BYTES": 512 * 128, "RING": 2, "BLOCKS_PER_SM": 1},
             {"UNIT_BYTES": 32 * 128, "RING": 16, "BLOCKS_PER_SM": 3})
    for G in dma.GS:
        for order, st in pin["starts"].items():
            want = tile_copy_plain(pin["x"], st, G)
            errs["tile_copy"] = max(errs["tile_copy"], assert_same(
                f"K11 n={dma.N} G={G} {order} starts", (tile_copy(pin["x"], st, G),), (want,)))
            for values in plans:
                with copy_sweep.plan(**values) as plan:
                    errs["tile_copy"] = max(errs["tile_copy"], assert_same(
                        f"K11 n={dma.N} G={G} {order} starts, {plan}",
                        (tile_copy(pin["x"], st, G),), (want,)))
    errs["tile_copy"] = max(errs["tile_copy"], check_tile_copy_streams(dev, g, pin))
    for w, tile, G, n in ((8, 256, 64, 256 * 37), (4, 64, 32, 64 * 5), (512, 128, 32, 128 * 9)):
        x = torch.from_numpy(g.integers(-2**31, 2**31, n * w).astype(np.int32)).to(dev)
        st = torch.from_numpy((g.permutation(n // tile) * tile).astype(np.int32))
        errs["tile_copy"] = max(errs["tile_copy"], assert_same(
            f"K11 W={w} T={tile} G={G} n={n}", (tile_copy(x, st, G, tile, w),),
            (tile_copy_plain(x, st, G, tile, w),)))
    for load in (True, False):
        errs["row_move"] = max(errs["row_move"], assert_same(
            f"K12 N={prims.N} tile={prims.T} load={load}",
            (row_move(pin["rows"], pin["slot"], prims.T, load),),
            (row_move_plain(pin["rows"], pin["slot"], prims.T, load),)))
    for n in sizes:
        for w in (5, prims.W):
            x = torch.from_numpy(g.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)).to(dev)
            load_slot = g.integers(-3, n + 3, size=n).astype(np.int32)
            store_slot = g.permutation(n).astype(np.int32)
            store_slot[g.random(n) < 0.2] = n + 1  # these rows land nowhere
            for load, slot in ((True, load_slot), (False, store_slot)):
                s = torch.from_numpy(slot).to(dev)
                errs["row_move"] = max(errs["row_move"], assert_same(
                    f"K12 N={n} W={w} one tile load={load}",
                    (row_move(x, s, max(n, 1), load),), (row_move_plain(x, s, max(n, 1), load),)))
    torch.cuda.synchronize()
    log(f"[kernels] K11 equals its plain version at n={dma.N} for G in {dma.GS} with identity "
        f"and tile-permuted starts, under the default plan and {len(plans)} others (units "
        f"of 32-512 rows, rings of 2-16, blocks that reload their ring tens of times), two "
        f"calls on two streams at once, and at W 8, 4 and 512 with permuted starts; K12 in both modes at N={prims.N} "
        f"in tiles of {prims.T} (W={prims.W}) and as one tile at N in {sizes} (W 5 and "
        f"{prims.W}) with slots outside the tile")
    errs["row_move"] = max(errs["row_move"], check_row_move_cases(dev, g))
    return errs


def check_tile_copy_streams(dev, g, pin) -> int:
    """Two K11 calls on two streams at once, each with its own unit counter:
    a permuted copy at G = 32 and an identity one at G = 128 of other words,
    under the default plan and under one block an SM (so that both grids
    fit the card together), 5 rounds each; each equals its plain version."""
    from database_technology_algorithms_tpu_torch.kernels.tile_copy import (
        tile_copy, tile_copy_plain)
    from database_technology_algorithms_tpu_torch.tools import copy_sweep

    x1, x2 = pin["x"], torch.flip(pin["x"], (0,)).contiguous()
    s1, s2 = pin["starts"]["tile-permuted"], pin["starts"]["identity"]
    want = (tile_copy_plain(x1, s1, 32), tile_copy_plain(x2, s2, 128))
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    err = 0
    for values in ({}, {"UNIT_BYTES": 64 * 128, "RING": 8, "BLOCKS_PER_SM": 1}):
        with copy_sweep.plan(**values) as plan:
            for _ in range(5):
                torch.cuda.synchronize()
                with torch.cuda.stream(streams[0]):
                    a = tile_copy(x1, s1, 32)
                with torch.cuda.stream(streams[1]):
                    b = tile_copy(x2, s2, 128)
                torch.cuda.synchronize()
                err = max(err, assert_same(f"K11 two streams at once, {plan}", (a, b), want))
    return err


def check_row_move_cases(dev, g) -> int:
    """K12 against its plain version at the row-move engine's edges: row
    widths W of 1, 3, 5 and 36 words, rows 2049 and 4099 in tiles of 1, 7,
    2048 and 4096 (a last tile cut short, a tile past the rows), slots at and
    past the tile's edges, x 1 to 3 words past a 16-byte boundary, and every
    live-count form of the load."""
    from database_technology_algorithms_tpu_torch.kernels.row_move import (
        row_move, row_move_plain)

    err, calls = 0, 0
    for w in MOVE_WIDTHS:
        for n in (2049, 4099):
            x = torch.from_numpy(g.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)).to(dev)
            views = {"aligned": x, **{f"{k} words past 16 B": unaligned(x, k) for k in (1, 2, 3)}}
            for tile in (1, 7, 2048, 4096):
                load_slot = torch.from_numpy(
                    g.integers(-2, tile + 2, size=n).astype(np.int32)).to(dev)
                store = np.concatenate([g.permutation(min(tile, n - t0))
                                        for t0 in range(0, n, tile)]).astype(np.int32)
                store[g.random(n) < 0.2] = tile  # these rows land nowhere
                store_slot = torch.from_numpy(store).to(dev)
                for what, xv in views.items():
                    shape = f"N={n} W={w} tile={tile} {what}"
                    for form, count in live_counts(dev, n).items():
                        err = max(err, assert_same(
                            f"K12 {shape} load, count {form}",
                            (row_move(xv, load_slot, tile, True, count),),
                            (row_move_plain(xv, load_slot, tile, True, count),)))
                    err = max(err, assert_same(
                        f"K12 {shape} store", (row_move(xv, store_slot, tile, False),),
                        (row_move_plain(xv, store_slot, tile, False),)))
                    calls += len(live_counts(dev, n)) + 1
    # beyond the 50 MB L2 (the plan's small spans): 4M rows of 5 words, one tile
    n = 4_000_000
    x = torch.randint(-2**31, 2**31, (n, 5), dtype=torch.int32, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(13))
    slot = torch.randperm(n, device=dev, generator=torch.Generator(device=dev).manual_seed(14))
    slot = slot.to(torch.int32)
    for form, count in (("none", None), ("card", torch.tensor(n // 3, dtype=torch.int32,
                                                               device=dev))):
        err = max(err, assert_same(f"K12 N={n} W=5 one tile load, count {form}",
                                   (row_move(x, slot, n, True, count),),
                                   (row_move_plain(x, slot, n, True, count),)))
    err = max(err, assert_same(f"K12 N={n} W=5 one tile store",
                               (row_move(x, slot, n, False),), (row_move_plain(x, slot, n, False),)))
    calls += 3
    del x, slot
    torch.cuda.synchronize()
    log(f"[kernels] K12 equals its plain version in {calls} more calls: W in {MOVE_WIDTHS}, N in "
        f"(2049, 4099), tiles of 1, 7, 2048 and 4096 with slots past the tile's edges, x aligned "
        f"and 1-3 words past 16 B, the load with every live-count form, the store; and beyond L2 "
        f"4M rows of 5 words as one tile")
    return err


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
    for m in (2, 3):
        for n, case, mat, inact in radix_edge_inputs(g, m):
            mat_t = torch.from_numpy(mat.view(np.int32)).to(dev)
            words = [mat_t[:, j] for j in range(m)]
            for mask in (torch.from_numpy(inact).to(dev), None):
                got = words_sort(words, mask)
                want = words_sort_plain(words, mask)
                errs["words_sort"] = max(errs["words_sort"], assert_same(
                    f"K5 n={n} m={m} {case} mask={mask is not None}", got[:2], want[:2]))
    torch.cuda.synchronize()
    log(f"[kernels] K5-K7 equal their plain versions at n in {sizes}: K5 with 1, 2, 3, 9 "
        f"and 33 words (strided columns, words >= 2^31, all rows inactive, all keys equal, "
        f"no mask), and with 2 and 3 strided words at the radix tile's edges and {2 * ROWS} rows "
        f"({RADIX_EDGE_CASES}, with and without the mask); K6 through perm and in place, "
        f"K7 with lo > 0, int32 and bool")
    return errs


GATHER_EDGE_ROWS = (1, 5, 4099, 70_001)  # a thread's tail, a block's edge, many blocks
GATHER_EDGE_WORDS = (1, 2, 3, 4, 5, 8, 9)  # direct, packed groups, past MAX_WORDS = 8
GATHER_FORMS = {"direct": 1 << 62, "packed": 0}  # GATHER_PACK_BYTES that force each form


def check_gather_words_cases(dev, g) -> int:
    """``gather_words`` (K1's and K5's gather of their extra words, in the
    form ``radix_plan.gather_packed`` picks) at its edges: both forms, 1-9
    words (packed groups of 4, a direct word past them, more than
    MAX_WORDS), rows that end inside a thread's run, extras 1-3 words past
    16 bytes; each K1 and K5 call's outputs against its plain version."""
    from database_technology_algorithms_tpu_torch.kernels import radix_plan
    from database_technology_algorithms_tpu_torch.kernels.radix_sort import (
        view_sort, view_sort_plain)
    from database_technology_algorithms_tpu_torch.kernels.words_sort import (
        words_sort, words_sort_plain)

    err, calls = 0, 0
    default = radix_plan.GATHER_PACK_BYTES
    for n in GATHER_EDGE_ROWS:
        key = torch.from_numpy(g.integers(0, max(n // 2, 1), size=n).astype(np.int32)).to(dev)
        inact = torch.from_numpy(g.random(n) < 0.2).to(dev)
        for m in GATHER_EDGE_WORDS:
            extra = tuple(
                unaligned(torch.from_numpy(g.integers(-2**31, 2**31, size=n).astype(np.int32))
                          .to(dev), (m + j) % 4) for j in range(m))
            want1 = view_sort_plain(inact, key, extra)
            want5 = words_sort_plain([key], inact, extra)
            for form, limit in GATHER_FORMS.items():
                radix_plan.GATHER_PACK_BYTES = limit
                try:
                    got1 = view_sort(inact, key, extra)
                    got5 = words_sort([key], inact, extra)
                finally:
                    radix_plan.GATHER_PACK_BYTES = default
                what = f"gather_words n={n} words={m} {form}"
                err = max(err, assert_same(f"K1 {what}", got1[:3] + got1[3], want1[:3] + want1[3]))
                err = max(err, assert_same(f"K5 {what}", got5[:2] + got5[2], want5[:2] + want5[2]))
                calls += 2
    torch.cuda.synchronize()
    log(f"[kernels] gather_words equals the plain versions in {calls} K1 and K5 calls: rows "
        f"{GATHER_EDGE_ROWS}, words {GATHER_EDGE_WORDS} (extras 0-3 words past 16 bytes), "
        f"packed and direct")
    return err


ADJ_WORDS = (1, 2, 3, 4, 5, 9, 33, 40)  # K6's key widths: one stage, several, the most
ADJ_LAYOUTS = ("contiguous", "strided", "odd column", "num + strw")
ADJ_KEYS = ("few values", "all equal", "all distinct")
# (key words, layout) of the multi-stage keys also checked at the main path's
# 2M rows: field 3's num beside strw, and the most words in one matrix
ADJ_LARGE_MULTI = ((9, "num + strw"), (40, "strided"))


def adj_edge_sizes() -> list[int]:
    """K6's and K7's rows at their layouts' edges: a K6 warp's and block's
    rows at the plan's R, a K7 block's (one row a thread), one past and one
    short of each, and the sizes of the other checks."""
    from database_technology_algorithms_tpu_torch.kernels import perm_plan

    r6 = perm_plan.ADJ_ROWS
    block6, block7 = perm_plan.THREADS * r6, perm_plan.THREADS
    edges = {0, 1, 31, 32, 33, 32 * r6 - 1, 32 * r6, 32 * r6 + 1, block6 - 1, block6,
             block6 + 1, block7 - 1, block7, block7 + 1, 2049, 70_001, 2 * ROWS}
    return sorted(edges)


def adj_key_words(g, n: int, m: int, layout: str, keys: str, dev) -> list[torch.Tensor]:
    """m key words of n rows laid out as `layout`: separate contiguous
    columns, columns of one row-major [n, m] matrix, columns 1..m of an
    [n, m + 1] matrix (4 bytes past its start), or a separate num column
    beside m - 1 columns of a matrix (field 3's key)."""
    if keys == "all equal":
        mat = np.zeros((n, m + 1), np.uint32)
    else:
        # few values a word, so ties reach the last word; a third >= 2^31
        mat = (g.integers(0, 3, size=(n, m + 1)).astype(np.uint32) << 30) | g.integers(
            0, 2, size=(n, m + 1)).astype(np.uint32)
        if keys == "all distinct":
            mat[:, -1] = np.arange(n, dtype=np.uint32)
            mat[:, 0] = np.arange(n, dtype=np.uint32)
    t = torch.from_numpy(mat.view(np.int32)).to(dev)
    if layout == "contiguous":
        return [t[:, j + 1].contiguous() for j in range(m)]
    if layout == "strided":
        t = t[:, 1:].contiguous()
        return [t[:, j] for j in range(m)]
    if layout == "odd column":
        return [t[:, j + 1] for j in range(m)]
    strw = t[:, 2:].contiguous()
    return [t[:, 1].contiguous()] + [strw[:, j] for j in range(m - 1)]


def check_adj_cases(dev, g) -> int:
    """K6 against its plain version at its layout's edges: rows at a warp's
    and a block's edges, 1-40 key words (one chunk of 4 and several), each
    layout of ADJ_LAYOUTS (contiguous, strided, 4 bytes past a matrix's
    start, field 3's num beside strw), keys with few values, all equal and
    all distinct, through the keys' sort order, a random perm and in place."""
    from database_technology_algorithms_tpu_torch.kernels.adj_equal import (
        adj_equal, adj_equal_plain)
    from database_technology_algorithms_tpu_torch.kernels.words_sort import words_sort

    err, calls = 0, 0
    for n in adj_edge_sizes():
        rand = torch.from_numpy(g.permutation(n).astype(np.int32)).to(dev)
        for m in ADJ_WORDS:
            for keys in ADJ_KEYS:
                for layout in ADJ_LAYOUTS if keys == "few values" else ("strided",):
                    # above 70001 rows, keys of several stages in two layouts
                    if m > 4 and n > 70_001 and (m, layout) not in ADJ_LARGE_MULTI:
                        continue
                    words = adj_key_words(g, n, m, layout, keys, dev)
                    for form, perm in (("sorted", words_sort(words)[0]), ("random", rand),
                                       ("in place", None)):
                        err = max(err, assert_same(
                            f"K6 n={n} m={m} {layout} {keys} {form}",
                            (adj_equal(words, perm),), (adj_equal_plain(words, perm),)))
                        calls += 1
    torch.cuda.synchronize()
    log(f"[kernels] K6 equals its plain version in {calls} more calls: n in {adj_edge_sizes()}, "
        f"m in {ADJ_WORDS} (m > 4 up to 70001 rows, and {ADJ_LARGE_MULTI} at every n), "
        f"layouts {ADJ_LAYOUTS}, keys {ADJ_KEYS}, "
        f"through the keys' sort order, a random perm and in place")
    return err


def check_unpermute_cases(dev, g) -> int:
    """K7's scatter at its layout's edges (rows around a block's), every
    (lo, m) window of check_sort_kernels, int32 and bool values, aligned
    and one element past 16 bytes."""
    from database_technology_algorithms_tpu_torch.kernels.unpermute import (
        unpermute, unpermute_plain)

    sizes = sorted(set(adj_edge_sizes()) | {7, 8, 9, 15, 16, 17})
    err, calls = 0, 0
    for n in sizes:
        perm = torch.from_numpy(g.permutation(n).astype(np.int32)).to(dev)
        vals = torch.from_numpy(g.integers(-2**31, 2**31, size=n + 1).astype(np.int32)).to(dev)
        flags = torch.from_numpy(g.random(n + 1) < 0.5).to(dev)
        views = {"aligned": (perm, vals[:n], flags[:n]),
                 "1 past 16 B": (unaligned(perm, 1), vals[1:], flags[1:])}
        for what, (p, v, f) in views.items():
            for lo, m_out in ((0, n), (n // 2, n - n // 2), (n // 3, n // 3), (n, 0)):
                for vv in (v, f):
                    err = max(err, assert_same(
                        f"K7 n={n} {what} lo={lo} m={m_out} {vv.dtype}",
                        (unpermute(p, vv, lo, m_out),), (unpermute_plain(p, vv, lo, m_out),)))
                    calls += 1
    torch.cuda.synchronize()
    log(f"[kernels] K7's scatter equals its plain version in {calls} more calls: n in {sizes} "
        f"(a block's rows, and one past and short of them), windows (0, n), (n/2, n - n/2), "
        f"(n/3, n/3), (n, 0), int32 and bool, aligned and 1 element past 16 B")
    return err


GATHER_COUNTS = ("none", "int", "card", "zero", "past n")


def gather_edges(dev) -> set:
    """A K7 gather block's rows and the rows of its grid's first walk (the
    plan's waves of the card's blocks), with one past and one short of
    each."""
    from database_technology_algorithms_tpu_torch.kernels import perm_plan

    block = perm_plan.THREADS * perm_plan.GATHER_ROWS
    wave = perm_plan.blocks(1 << 30, perm_plan.GATHER_ROWS, perm_plan.GATHER_WAVES, dev) * block
    return {block - 1, block, block + 1, wave - 1, wave, wave + 1}


def check_gather_cases(dev, g) -> int:
    """K7's gather against its plain version and against the scatter
    through K9's "si" on the same staging (their result while nothing
    overflowed): 1-4097 cells, every live-count form, roomy cells and
    cells that overflow (slots at nparts * cap give 0)."""
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import stage_to_cells
    from database_technology_algorithms_tpu_torch.kernels.unpermute import (
        unpermute, unpermute_gather, unpermute_gather_plain)

    sizes = sorted({1, 31, 2049, 70_001, 2 * ROWS} | gather_edges(dev))
    err, calls, vs_scatter = 0, 0, 0
    for n in sizes:
        for nparts in (1, 2, 16, 4096, 4097):
            even = -(-n // nparts)
            dest = torch.from_numpy(g.integers(0, nparts, size=n).astype(np.int32)).to(dev)
            word = torch.from_numpy(g.integers(-2**31, 2**31, size=n).astype(np.int32)).to(dev)
            for cap in (max(2 * even, 8), max(even // 2, 1)):
                counts = {"none": None, "int": n // 3,
                          "card": torch.tensor(n // 2, dtype=torch.int32, device=dev),
                          "zero": 0, "past n": torch.tensor(n + 5, dtype=torch.int32,
                                                            device=dev)}
                for form, count in counts.items():
                    _, cnt, slots, ovf = stage_to_cells(dest, None, nparts, cap, [word],
                                                        "slots", count, True)
                    first = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
                    vals = torch.from_numpy(g.integers(0, 5, size=n).astype(np.int32)).to(dev)
                    got = unpermute_gather(slots, vals, first, cap, count)
                    err = max(err, assert_same(
                        f"K7 gather n={n} nparts={nparts} cap={cap} count {form}",
                        (got,), (unpermute_gather_plain(slots, vals, first, cap, count),)))
                    calls += 1
                    if int(ovf) == 0:
                        _, _, si, _ = stage_to_cells(dest, None, nparts, cap, [word], "si",
                                                     count, True)
                        staged = torch.arange(n, device=dev) < cnt.sum()
                        err = max(err, assert_same(
                            f"K7 gather against the scatter through si n={n} nparts={nparts} "
                            f"cap={cap} count {form}", (got,),
                            (unpermute(si, torch.where(staged, vals, 0)),)))
                        vs_scatter += 1
    torch.cuda.synchronize()
    log(f"[kernels] K7's gather equals its plain version in {calls} calls and the scatter "
        f"through K9's 'si' in {vs_scatter} of them (the rest overflowed): n in {sizes}, "
        f"nparts in (1, 2, 16, 4096, 4097), a roomy cap and one that "
        f"overflows, counts {GATHER_COUNTS}")
    return err


def check_overbudget_kernels(dev, g, sizes) -> dict:
    """K8, K9 and K10 against their plain versions on the card."""
    from database_technology_algorithms_tpu_torch.kernels.hash_words import (
        hash_words, hash_words_plain)

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
    torch.cuda.synchronize()
    log(f"[kernels] K8 equals its plain version at n in {sizes}: 1, 2, 3, 9 and 33 strided "
        f"words, words >= 2^31, zero words in and before the skipped range, seeds 0 and 1")
    errs["stage_cells"] = check_stage_cases(dev, g, sizes)
    errs["member_mult"] = check_table_cases(dev, g, sizes)
    return errs


STAGE_FORMS = ("all", "70% inactive", "count int", "count card", "mask and count")


def stage_forms(dev, g, n: int) -> dict:
    """K9's liveness forms: {name: (active, count)}; "70% inactive" is a
    sink-heavy side, the count forms the tiled join's."""
    active = torch.from_numpy(g.random(n) < 0.3).to(dev)
    return {"all": (None, None), "70% inactive": (active, None), "count int": (None, n // 3),
            "count card": (None, torch.tensor(n // 2, dtype=torch.int32, device=dev)),
            "mask and count": (active, torch.tensor(2 * n // 3, dtype=torch.int32, device=dev))}


def check_stage_cases(dev, g, sizes) -> int:
    """K9 against its plain version: nparts of 1, 2, 16, 4096 and 4097
    (the tiled join's 4096 and one past), destinations at and above nparts,
    every liveness form, the three row maps, 1 and 3 payload words (one
    strided pair), a roomy cap and one that overflows; all rows in one cell;
    the count span's edges; "si" with and without the in-range promise; the
    count form against the mask form; value_boundaries."""
    from database_technology_algorithms_tpu_torch.kernels import cells_plan
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
        stage_to_cells, stage_to_cells_plain, value_boundaries, value_boundaries_plain)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    def check(what, dest, act, nparts, cap, payloads, row_map, count=None, in_range=False):
        got = stage_to_cells(dest, act, nparts, cap, payloads, row_map, count, in_range)
        want = stage_to_cells_plain(dest, act, nparts, cap, payloads, row_map, count)
        maps = ((got[2],), (want[2],)) if row_map != "none" else ((), ())
        return assert_same(f"K9 {what} nparts={nparts} cap={cap} w={len(payloads)} {row_map}",
                           (*got[0], got[1], got[3].reshape(1), *maps[0]),
                           (*want[0], want[1], want[3].reshape(1), *maps[1]))

    err, calls = 0, 0
    span = cells_plan.SPAN
    edges = [span - 1, span, span + 1, 2 * span + 33]
    for n in list(sizes) + edges:
        pay = i32(g.integers(0, 2**32, size=(n, 2), dtype=np.uint64))
        lone = i32(g.integers(0, 2**32, size=n, dtype=np.uint64))
        forms = stage_forms(dev, g, n)
        for nparts in (1, 2, 16, 4096, 4097):
            dest = i32(g.integers(0, nparts + 3, size=n))  # some above nparts
            even = -(-n // nparts)
            for cap in (max(2 * even, 8), max(even // 2, 1)):
                for form, (act, count) in forms.items():
                    for payloads in ([lone], [pay[:, 0], lone, pay[:, 1]]):
                        for row_map in ("slots", "si", "none"):
                            err = max(err, check(f"n={n} {form}", dest, act, nparts, cap,
                                                 payloads, row_map, count))
                            calls += 1
            for nprobes in (1, nparts + 1, 1025):
                err = max(err, assert_same(
                    f"value_boundaries n={n} nprobes={nprobes}",
                    (value_boundaries(dest, nprobes),), (value_boundaries_plain(dest, nprobes),)))
        # every row in one cell: the cap overflows; and the in-range promise
        one = i32(np.full(n, 5, np.uint32))
        inside = i32(g.integers(0, 4096, size=n))
        for form, (act, count) in forms.items():
            err = max(err, check(f"n={n} one cell, {form}", one, act, 16, max(n // 4, 1),
                                 [lone], "si", count))
            err = max(err, check(f"n={n} in range, {form}", inside, act, 4096, max(n // 2048, 8),
                                 [lone], "si", count, in_range=True))
            calls += 2
    # the count form is the mask form of arange(n) < count, beyond L2
    n = OVER_ROWS
    dest = torch.randint(0, 4096, (n,), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(13))
    word = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(14))
    live = torch.tensor(6_942_000, dtype=torch.int32, device=dev)
    mask = torch.arange(n, device=dev) < live
    for row_map in ("si", "slots"):
        a = stage_to_cells(dest, None, 4096, 8792, [word], row_map, live, in_range=True)
        b = stage_to_cells(dest, mask, 4096, 8792, [word], row_map)
        err = max(err, assert_same(f"K9 {n} rows, count form against mask form, {row_map}",
                                   (*a[0], a[1], a[2], a[3].reshape(1)),
                                   (*b[0], b[1], b[2], b[3].reshape(1))))
        err = max(err, check(f"n={n} 6.94M live", dest, None, 4096, 8792, [word], row_map, live,
                             in_range=True))
        calls += 3
    del dest, word, mask
    torch.cuda.synchronize()
    log(f"[kernels] K9 equals its plain version in {calls} calls: n in {list(sizes) + edges} "
        f"(the count span's edges at {span} rows), nparts in (1, 2, 16, 4096, 4097), "
        f"destinations above nparts, the liveness forms {STAGE_FORMS}, the three row maps, 1 "
        f"and 3 payload words, a roomy and an overflowing cap, all rows in one cell, 'si' with "
        f"and without the in-range promise, {OVER_ROWS} rows with 6.94M live (count form equal "
        f"to the mask form); value_boundaries on both sides of 1024 probes")
    return err


def check_table_cases(dev, g, sizes) -> int:
    """K10 against its plain version: G pairs of about 1024 rows a side and
    the whole n as one pair, 1, 2, 3 and 33 key words (field 3's width),
    repeated and unsorted build keys, n_bkeys of 0 and of cap_b, dead query
    rows, the compacted output; the global table (a skewed pair beside
    pairs that fit the shared table, and the retry's doubled capacities);
    two keys whose 32-bit hashes are equal."""
    from database_technology_algorithms_tpu_torch.kernels import cells_plan
    from database_technology_algorithms_tpu_torch.kernels.member_mult import (
        member_multiplicity_cells, member_multiplicity_cells_plain)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    def check(what, bmat, kmat, nbk, nkk, live):
        m = bmat.shape[-1]
        bw = [bmat[..., j].contiguous() for j in range(m)]
        kw = [kmat[..., j].contiguous() for j in range(m)]
        err = 0
        for nk, lv in ((nkk, None), (None, live), (nkk, live)):
            err = max(err, assert_same(
                f"K10 {what} m={m}", (member_multiplicity_cells(bw, nbk, kw, nk, lv),),
                (member_multiplicity_cells_plain(bw, nbk, kw, nk, lv),)))
        first = torch.cumsum(nkk, 0, dtype=torch.int32) - nkk
        size = int(nkk.sum()) + 7
        got = torch.full((size,), 9, dtype=torch.int32, device=dev)
        want = got.clone()
        member_multiplicity_cells(bw, nbk, kw, nkk, live, got, first)
        member_multiplicity_cells_plain(bw, nbk, kw, nkk, live, want, first)
        return max(err, assert_same(f"K10 {what} m={m}, compacted", (got,), (want,)))

    def pairs_input(pairs, cap_b, cap_k, m, pool):
        keys = g.integers(0, 2**32, size=(pool, m), dtype=np.uint64)
        bmat = i32(keys[g.integers(0, pool, size=(pairs, cap_b))])
        kmat = i32(keys[g.integers(0, pool, size=(pairs, cap_k))])
        nbk = g.integers(0, cap_b + 1, size=pairs)
        nbk[::3] = cap_b
        nbk[1::3] = 0
        nkk = g.integers(0, cap_k + 1, size=pairs)
        nkk[::2] = cap_k
        live = torch.from_numpy(g.random((pairs, cap_k)) < 0.8).to(dev)
        return bmat, kmat, t(nbk), t(nkk), live

    err, calls = 0, 0
    for n in sizes:
        for pairs in sorted({max(n // 1024, 1), 1}):
            cap_b = -(-n // pairs)
            for m in (1, 2, 3, 33):
                if m == 33 and n > 70_001:
                    continue
                bmat, kmat, nbk, nkk, live = pairs_input(pairs, cap_b, cap_b + 8, m,
                                                         max(cap_b // 3, 2))
                err = max(err, check(f"n={n} pairs={pairs}", bmat, kmat, nbk, nkk, live))
                calls += 4
    # the global table: a skewed pair among pairs that fit the shared table,
    # at the over-budget step's capacity (8792) and at the retry's doubled one
    for cap_b in (8792, 2 * 8792):
        for m in (1, 2, 3):
            pairs = 24
            bmat, kmat, nbk, nkk, live = pairs_input(pairs, cap_b, cap_b, m, cap_b // 2)
            nb = g.integers(1600, 1800, size=pairs)
            nb[::5] = cap_b  # every build row live: table_slots(cap_b) slots
            nb[1] = 0
            shared = cells_plan.table_cap(cap_b, m, cells_plan.TABLE_BYTES)
            need = [cells_plan.table_slots(int(x)) for x in nb]
            if not (max(need) > shared >= min(need)):
                raise AssertionError(f"K10 check: pairs of {need} slots do not straddle the "
                                     f"shared table's {shared}")
            err = max(err, check(f"global table, cap_b={cap_b}, shared {shared}", bmat, kmat,
                                 t(nb), nkk, live))
            calls += 4
    # two two-word keys with one 32-bit table hash (found on the host by the
    # kernel's murmur3): the words decide
    cand = g.integers(0, 2**32, size=(1 << 17, 2), dtype=np.uint64).astype(np.uint32)
    h = cells_plan.table_hash(cand)
    order = np.argsort(h, kind="stable")
    dup = np.nonzero(np.diff(h[order]) == 0)[0]
    if dup.size:
        a, b = cand[order[dup[0]]], cand[order[dup[0] + 1]]
        bmat = i32(np.stack([a, a, a, b])[None])
        kmat = i32(np.stack([b, a, b, a, b])[None])
        got = member_multiplicity_cells([bmat[..., 0].contiguous(), bmat[..., 1].contiguous()],
                                        t([4]), [kmat[..., 0].contiguous(),
                                                 kmat[..., 1].contiguous()])
        if got.cpu().tolist() != [[1, 3, 1, 3, 1]]:
            raise AssertionError(f"K10 on two keys with one hash: {got.cpu().tolist()}")
        calls += 1
    torch.cuda.synchronize()
    log(f"[kernels] K10 equals its plain version in {calls} calls: batched pairs at n in "
        f"{sizes} with 1, 2, 3 and 33 key words, repeated and unsorted build keys, n_bkeys of 0 "
        f"and of cap, dead query rows, the compacted output; pairs of 8792 and 17584 build rows "
        f"whose skewed pairs take the global table beside pairs in the shared one; two keys with "
        f"one 32-bit hash {'found and held' if dup.size else 'not found'}")
    return err


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


H100 = "NVIDIA H100 80GB HBM3"
NATIVE_WRITE_BLOCKS = 1000  # 100,000 rows through the native writer


def trace_events(logdir: Path) -> list:
    """The events of the one Chrome trace file that ``profiling.trace``
    wrote into `logdir`."""
    import gzip

    files = sorted(logdir.glob("*.json*"))
    if len(files) != 1:
        raise AssertionError(f"profiling.trace wrote {[f.name for f in files]} into {logdir}")
    opener = gzip.open if files[0].suffix == ".gz" else open
    with opener(files[0], "rt") as f:
        return json.load(f)["traceEvents"]


def phase_utils(dev, card: str, pipe: dict) -> dict:
    """The port's utilities on the card: ``profiling.timed`` and
    ``timed_steady`` on the staged 1M + 1M pipeline beside this script's
    ``cuda_ms`` and ``wall_ms``, and its output checked again; a
    ``profiling.trace`` of stage A under ``annotate("stage_a")`` and the
    materialization, which must hold that span and a one-sweep kernel;
    ``roofline.audit("pipeline", ...)`` of the timed run; ``chip_hbm_gbps()``
    of the card (3350.0 on an H100 80GB HBM3); ``write_blockfile_native`` of
    100,000 rows against the numpy writer's bytes (``[utils]`` lines)."""
    from database_technology_algorithms_tpu_torch.io import blockfile, native
    from database_technology_algorithms_tpu_torch.io.generator import generate_columns
    from database_technology_algorithms_tpu_torch.models.pipeline import make_pipeline_staged
    from database_technology_algorithms_tpu_torch.utils import profiling, roofline

    r, s, _ = pipe["inputs"]
    r_cols, s_cols = pipe["cols"]
    run = make_pipeline_staged(1)
    best_s, out = profiling.timed(run, r, s, reps=10, warmup=2)
    check_run(out, oracle(r_cols, s_cols, 1), r_cols, "field 1, profiling.timed's output")
    per_s, first_s = profiling.timed_steady(run, (r, s), k=20, reps=5)
    if not all(0 < x < 60 for x in (best_s, per_s, first_s)):
        raise AssertionError(f"profiling: timed {best_s}, timed_steady {per_s}, {first_s}")
    ev_ms, host_ms = cuda_ms(lambda: run(r, s)), wall_ms(lambda: run(r, s))
    log(f"[utils] {card}: staged {ROWS}+{ROWS}, field 1: profiling.timed {best_s * 1e3:.4f} ms "
        f"(best of 10), timed_steady {per_s * 1e3:.4f} ms a call (k 20, first call "
        f"{first_s * 1e3:.4f} ms); this script's cuda_ms {ev_ms:.4f} ms (CUDA events over 20 "
        f"back-to-back calls), wall_ms {host_ms:.4f} ms (median of 10 synchronized calls)")

    logdir = ROOT / "build" / "utils_trace"
    shutil.rmtree(logdir, ignore_errors=True)
    with profiling.trace(str(logdir)):
        with profiling.annotate("stage_a"):
            a_out = run.stage_a(r, s)
        with profiling.annotate("materialize"):
            run.materialize(a_out, r, s)
        torch.cuda.synchronize()
    events = trace_events(logdir)
    shutil.rmtree(logdir, ignore_errors=True)
    spans = [e for e in events if e.get("name") == "stage_a"]
    sweeps = [e for e in events if e.get("cat") == "kernel" and "onesweep_" in e.get("name", "")]
    if not spans or not sweeps:
        raise AssertionError(f"the trace holds {len(spans)} 'stage_a' spans and {len(sweeps)} "
                             f"one-sweep kernels")
    log(f"[utils] profiling.trace: {len(events)} events, the 'stage_a' span "
        f"({len(spans)} events) and {len(sweeps)} one-sweep kernel launches")

    gbps = roofline.chip_hbm_gbps()
    if torch.cuda.get_device_name(0) == H100 and gbps != 3350.0:
        raise AssertionError(f"chip_hbm_gbps() gives {gbps} on an {H100}")
    res = roofline.audit("pipeline", ROWS, best_s)
    log(f"[utils] {card}: chip_hbm_gbps() {gbps}; roofline.audit: {res.line()}")

    cols = generate_columns(NATIVE_WRITE_BLOCKS, seed=5)
    where = ROOT / "build" / "utils_native"
    where.mkdir(parents=True, exist_ok=True)
    if native.get_lib() is None:  # built at first use: not on the clock
        raise AssertionError("the native block-file library did not build")
    try:
        paths = [str(where / "native.bin"), str(where / "numpy.bin")]
        t0 = time.perf_counter()
        nblocks = native.write_blockfile_native(paths[0], cols)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        blockfile.write_blockfile(paths[1], cols)
        numpy_s = time.perf_counter() - t0
        same = Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()
    finally:
        shutil.rmtree(where, ignore_errors=True)
    if nblocks != NATIVE_WRITE_BLOCKS or not same:
        raise AssertionError(f"write_blockfile_native wrote {nblocks} blocks; bytes equal to "
                             f"the numpy writer's: {same}")
    log(f"[utils] write_blockfile_native: {len(cols['recid'])} rows in {nblocks} blocks, the "
        f"numpy writer's bytes; host wall {native_s * 1e3:.1f} ms against numpy's "
        f"{numpy_s * 1e3:.1f} ms")
    return {"timed_ms": best_s * 1e3, "steady_ms": per_s * 1e3, "cuda_ms": ev_ms,
            "wall_ms": host_ms, "hbm_gbps": gbps}


@contextlib.contextmanager
def recorded_take_fills():
    """The arguments of every K4 wrapper call made inside, in order, so that
    K4 can be timed at the shapes a path gives it (``RecordBatch.take_fill``
    looks the wrapper up in its module at each call).  The calls still
    launch the kernel."""
    from database_technology_algorithms_tpu_torch.kernels import take_fill as module

    calls, wrapper = [], module.take_fill

    def record(*args, **kw):
        calls.append((args, kw))
        return wrapper(*args, **kw)

    module.take_fill = record
    try:
        yield calls
    finally:
        module.take_fill = wrapper


@contextlib.contextmanager
def recorded_calls(module_name: str, name: str):
    """The arguments of every call of the wrapper `name` of
    ``kernels/<module_name>.py`` made inside, in order, as (args, kwargs):
    the port's modules that imported it by name call a recording wrapper
    while the block runs.  The calls still launch the kernel."""
    module = importlib.import_module(f"{PKG}.kernels.{module_name}")
    calls, wrapper = [], getattr(module, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return wrapper(*args, **kw)

    users = [m for mod, m in sys.modules.items()
             if mod.startswith(PKG) and getattr(m, name, None) is wrapper]
    for m in users:
        setattr(m, name, record)
    try:
        yield calls
    finally:
        for m in users:
            setattr(m, name, wrapper)


@contextlib.contextmanager
def recorded_compactions():
    """The arguments of every K3 wrapper call made inside, in order: the
    modules that imported ``compact_words`` by name call a recording wrapper
    while the block runs.  The calls still launch the kernel."""
    from database_technology_algorithms_tpu_torch.kernels import compact as module

    calls, wrapper = [], module.compact_words

    def record(keep, payload):
        calls.append((keep, payload))
        return wrapper(keep, payload)

    users = [m for name, m in sys.modules.items()
             if name.startswith(PKG) and getattr(m, "compact_words", None) is wrapper]
    for m in users:
        m.compact_words = record
    try:
        yield calls
    finally:
        for m in users:
            m.compact_words = wrapper


def compact_timing(call, card: str, what: str) -> dict:
    """K3 at the shape of one recorded call: the kernel's device time beside
    its plain version's, ``masked_select`` of each word (a yardstick: kept
    rows only; a row-index slot as an ``arange``) and the byte bound (keep
    and every word read once, every word written once)."""
    from database_technology_algorithms_tpu_torch.kernels.compact import (
        compact_words, compact_words_plain)

    keep, payload = call
    n = keep.shape[0]
    cols = [torch.arange(w, w + n, dtype=torch.int32, device=keep.device)
            if isinstance(w, int) else w for w in payload]
    read = sum(0 if isinstance(w, int) else 4 for w in payload)
    nbytes = n + n * read + n * 4 * len(payload)
    rec = {"shape": f"{what}: {n} rows, {int(keep.sum())} kept, {len(payload)} words "
                    f"({sum(isinstance(w, int) for w in payload)} of them the row index)",
           "ms": device_ms(lambda: compact_words(keep, payload)),
           "plain_ms": device_ms(lambda: compact_words_plain(keep, payload)),
           "library_ms": device_ms(lambda: [torch.masked_select(c, keep) for c in cols]),
           "bound_ms": bound_ms(nbytes)}
    parts = device_parts(profile_device(lambda: compact_words(keep, payload), reps=10))
    log(f"[timing] {card}: compact ({rec['shape']}): device time per call: kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library masked_select "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({nbytes} B); by kernel: "
        f"{parts}")
    return rec


def take_fill_timing(call, card: str, what: str) -> dict:
    """K4 at the shape of one recorded call: the kernel's device time beside
    its plain version's, ``index_select`` of the same rows packed as one
    [N, 3+K] matrix (a yardstick: no fill, no count) and the byte bound (the
    index, the live source rows and every output row)."""
    from database_technology_algorithms_tpu_torch.kernels.take_fill import (
        take_fill, take_fill_plain)

    args, kw = call
    recid, num, strw, valid, idx = args[:5]
    count = args[5] if len(args) > 5 else kw.get("count")
    (n, k), m = strw.shape, idx.shape[0]
    j = idx.long()
    j = torch.where(j < 0, j + n, j)
    live = (j >= 0) & (j < n)
    if count is not None:
        live &= torch.arange(m, device=idx.device) < count
    nlive = int(live.sum())
    rows_packed = torch.cat([recid[:, None], num[:, None], valid.to(torch.int32)[:, None], strw], 1)
    picked = torch.where(live, j, 0)
    nbytes = m * 4 + nlive * (9 + 4 * k) + m * (9 + 4 * k)
    rec = {"shape": f"{what}: {m} output rows x (3+{k}) words from {n} rows, {nlive} live"
                    f"{', live count on the card' if isinstance(count, torch.Tensor) else ''}",
           "ms": device_ms(lambda: take_fill(*args, **kw)),
           "plain_ms": device_ms(lambda: take_fill_plain(*args[:5], count)),
           "library_ms": device_ms(lambda: torch.index_select(rows_packed, 0, picked)),
           "bound_ms": bound_ms(nbytes)}
    log(f"[timing] {card}: take_fill ({rec['shape']}): device time per call: kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library index_select (no fill) "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({nbytes} B)")
    return rec


def adj_timings(calls, card: str, what: str) -> list[dict]:
    """K6 at the shapes of recorded calls: the largest call through perm and
    the largest in place, each beside its plain version and its byte bound
    (perm where given, every key word and the flags)."""
    from database_technology_algorithms_tpu_torch.kernels import perm_plan
    from database_technology_algorithms_tpu_torch.kernels.adj_equal import (
        adj_equal, adj_equal_plain)

    def perm_of(call):
        args, kw = call
        return args[1] if len(args) > 1 else kw.get("perm")

    out = []
    for form, through in (("through perm", True), ("in place", False)):
        mine = [c for c in calls if (perm_of(c) is not None) == through]
        if not mine:
            continue
        call = max(mine, key=lambda c: c[0][0][0].shape[0])
        words, perm = list(call[0][0]), perm_of(call)
        n, m = words[0].shape[0], len(words)
        nbytes = (0 if perm is None else n * 4) + n * 4 * m + n
        widths, stages = perm_plan.key_plan(words)
        rec = {"shape": f"{what}: {n} rows, {m} key words {form} (read as {widths} in stages "
                        f"{stages}), the largest of {len(calls)} calls",
               "ms": device_ms(lambda: adj_equal(words, perm)),
               "plain_ms": device_ms(lambda: adj_equal_plain(words, perm)),
               "library_ms": None, "bound_ms": bound_ms(nbytes)}
        log(f"[timing] {card}: adj_equal ({rec['shape']}): device time per call: kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library none, bound "
            f"{rec['bound_ms']:.4f} ms ({nbytes} B)")
        out.append(rec)
    return out


def scatter_timing(call, card: str, what: str) -> dict:
    """K7's scatter at the shape of one recorded call, beside its plain
    version, ``scatter_`` of all rows (a yardstick: no window) and its byte
    bound (perm and the values read, the window written)."""
    from database_technology_algorithms_tpu_torch.kernels.unpermute import (
        unpermute, unpermute_plain)

    args, kw = call
    perm, vals = args[:2]
    lo = args[2] if len(args) > 2 else kw.get("lo", 0)
    m = args[3] if len(args) > 3 else kw.get("m")
    n = perm.shape[0]
    m = n - lo if m is None else m
    elem = vals.element_size()
    perm_long = perm.long()
    nbytes = n * (4 + elem) + m * elem
    rec = {"shape": f"{what}: {n} sorted rows -> {m} {vals.dtype} answers (lo = {lo})",
           "ms": device_ms(lambda: unpermute(perm, vals, lo, m)),
           "plain_ms": device_ms(lambda: unpermute_plain(perm, vals, lo, m)),
           "library_ms": device_ms(lambda: torch.empty_like(vals).scatter_(0, perm_long, vals)),
           "bound_ms": bound_ms(nbytes)}
    log(f"[timing] {card}: unpermute ({rec['shape']}): device time per call: kernel "
        f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library scatter_ of all rows "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms ({nbytes} B)")
    return rec


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
    k67 = {}  # K6's and K7's device time in a profiled run of the four stages
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
        k67[field] = {k: sum(us for name, us in prof["top"] if k in name)
                      for k in ("adj_equal", "unpermute")}
        log(f"[command profile]   field {field}: K6 {k67[field]['adj_equal']:.1f} us, K7 "
            f"{k67[field]['unpermute']:.1f} us of the {prof['busy_us']:.1f} us a run")
        if field == 2:  # K4's shapes in the command, timed in phase_timings
            with recorded_take_fills() as k4_calls:
                whole()
            torch.cuda.synchronize()
            log(f"[command stages] field 2: {len(k4_calls)} K4 calls recorded in the four stages "
                f"(the command's run launched {launches[2]['take_fill']})")
    return {"launches": launches, "cols": (r_cols, s_cols), "batches": (r, s),
            "k4_calls": k4_calls, "k67_us": k67}


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


# ---------------------------------------------------------------------------
# the placement route (EngineConfig(materialize="sort"/"sort2d"))

# what one staged run of each route must launch: the u32 fields place R
# directly ("sort"), the others and "sort2d" place survivor_dest's
# destinations (K2 ranks, K7), with K1 + K4 or K1 + K12
SORT_ROUTE_KERNELS = {
    ("sort", True): ("radix_sort", "seg_scan", "unpermute", "take_fill"),
    ("sort", False): ("words_sort", "adj_equal", "seg_scan", "unpermute", "radix_sort",
                      "take_fill"),
    ("sort2d", True): ("radix_sort", "seg_scan", "unpermute", "row_move"),
    ("sort2d", False): ("words_sort", "adj_equal", "seg_scan", "unpermute", "radix_sort",
                        "row_move"),
}
ROUTES = ("gather", "sort", "sort2d")


def same_batch(a, b, what: str) -> None:
    for col in ("recid", "num", "strw", "valid"):
        if not torch.equal(getattr(a, col), getattr(b, col)):
            raise AssertionError(f"{what}: column {col} differs")


def phase_sort_route(dev, card: str, pipe: dict) -> dict:
    from database_technology_algorithms_tpu_torch.config import EngineConfig
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.models.pipeline import make_pipeline_staged

    r, s, _ = pipe["inputs"]
    r_cols, s_cols = pipe["cols"]
    cfgs = {route: EngineConfig(materialize=route) for route in ROUTES}
    runs = {(route, f): make_pipeline_staged(f, cfgs[route]) for route in ROUTES for f in range(4)}
    launches = {}
    for field in (1, 0, 2, 3):
        want = oracle(r_cols, s_cols, field)
        gather_out = runs[("gather", field)](r, s)["join_out"]
        for route in ("sort", "sort2d"):
            run = runs[(route, field)]
            # ---- the main path of the route: counts from exactly one run ------
            reset_launches()
            out = run(r, s)
            torch.cuda.synchronize()
            launches[(route, field)] = dict(LAUNCHES)
            missing = [k for k in SORT_ROUTE_KERNELS[(route, field in (0, 1))] if LAUNCHES[k] == 0]
            if missing:
                raise AssertionError(f"{route} route, field {field}: never launched {missing}")
            got = check_run(out, want, r_cols, f"{route} route, field {field} {ROWS}+{ROWS}")
            same_batch(out["join_out"], gather_out, f"{route} route, field {field}")
            log(f"[sort route] {route}, field {field}, {ROWS}+{ROWS}: {json.dumps(got)} == numpy "
                f"oracle, every output column == the gather route's; launches "
                f"{ {k: v for k, v in launches[(route, field)].items() if v} }")
    check_operators_on_routes(dev, r, s, cfgs)

    # ---- the two routes side by side, in turns (gather, sort, sort2d, and back) --
    times = {}
    for field, rounds in ((1, 2), (2, 1)):
        order = list(ROUTES) + list(reversed(ROUTES)) if rounds == 2 else list(ROUTES)
        for route in order:
            run = runs[(route, field)]
            busy = profile_device(lambda: run(r, s))["busy_us"]
            wall = wall_ms(lambda: run(r, s))
            times.setdefault((route, field), []).append((busy, wall))
        for route in ROUTES:
            run = runs[(route, field)]
            a_out = run.stage_a(r, s)
            stage_b = device_ms(lambda: run.materialize(a_out, r, s))
            stage_a = device_ms(lambda: run.stage_a(r, s))
            reads = "; ".join(f"device {b:.1f} us, host wall {w:.4f} ms"
                              for b, w in times[(route, field)])
            log(f"[sort route] {card}: staged pipeline field {field}, {ROWS}+{ROWS}, route "
                f"{route}: per run {reads}; stage A device {stage_a * 1e3:.1f} us, stage B "
                f"device {stage_b * 1e3:.1f} us")
    prof = profile_device(lambda: runs[("sort", 1)](r, s))
    for name, us in prof["top"][:10]:
        log(f"[sort route profile]   field 1 sort {us:9.1f} us  {name[:90]}")
    a2d = runs[("sort2d", 1)].stage_a(r, s)
    # K7's bool form as the "sort" route calls it (packed_keep_backsort)
    with recorded_calls("unpermute", "unpermute") as k7_calls:
        runs[("sort", 1)](r, s)
    torch.cuda.synchronize()
    k7_bool = [c for c in k7_calls if c[0][1].dtype == torch.bool]
    if not k7_bool:
        raise AssertionError("the 'sort' route, field 1, launched K7 on no bool values")
    return {"launches": launches, "times": times, "inputs_2d": (r, a2d),
            "k7_bool": max(k7_bool, key=lambda c: c[0][0].shape[0])}


def check_operators_on_routes(dev, r, s, cfgs) -> None:
    """The stand-alone operators on 1M-row tables: each placement route's
    result equals the gather route's, column for column."""
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join
    from database_technology_algorithms_tpu_torch.ops.merge_join import (
        join_sorted_distinct, merge_join)
    from database_technology_algorithms_tpu_torch.ops.movement import compact_rows
    from database_technology_algorithms_tpu_torch.ops.sort import sort_batch

    g = np.random.default_rng(11)
    keep = torch.from_numpy(g.random(r.nrows) < 0.4).to(dev)
    extra = torch.from_numpy(g.integers(-2**31, 2**31, size=r.nrows).astype(np.int32)).to(dev)
    for field in (1, 3):
        d = {route: (distinct(r, field, cfg), distinct(s, field, cfg))
             for route, cfg in cfgs.items()}
        calls = {
            "sort_batch": lambda cfg, route: sort_batch(r, field, cfg),
            "distinct": lambda cfg, route: d[route][0],
            "merge_join": lambda cfg, route: merge_join(r, s, field, cfg)[:2],
            "join_sorted_distinct": lambda cfg, route: join_sorted_distinct(
                *d[route][0], *d[route][1], field, cfg),
            "hash_join": lambda cfg, route: hash_join(r, s, field, cfg),
            "compact_rows": lambda cfg, route: compact_rows(r, keep, (extra,), cfg),
        }
        for name, call in calls.items():
            base = call(cfgs["gather"], "gather")
            for route in ("sort", "sort2d"):
                got = call(cfgs[route], route)
                same_batch(got[0], base[0], f"{name} field {field} on the {route} route")
                for a, b in zip(got[1:], base[1:]):
                    for x, y in zip(a if isinstance(a, tuple) else (a,),
                                    b if isinstance(b, tuple) else (b,)):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{name} field {field} on the {route} route: "
                                                 f"a second result differs")
    torch.cuda.synchronize()
    log(f"[sort route] sort_batch, distinct, merge_join, join_sorted_distinct, hash_join and "
        f"compact_rows on {r.nrows}-row tables, fields 1 and 3: the sort and sort2d routes "
        f"equal the gather route, column for column")


def phase_probes(dev, card: str, g) -> dict:
    """The probes' own readings: K11 for each G, K12's P4 and P5."""
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.kernels.row_move import row_move_plain
    from database_technology_algorithms_tpu_torch.kernels.tile_copy import bulk_copies
    from database_technology_algorithms_tpu_torch.tools import bench_pallas_dma as dma
    from database_technology_algorithms_tpu_torch.tools import bench_permute_prims as prims

    pin = probe_inputs(dev, g)
    x, st, rows, slot = pin["x"], pin["starts"]["identity"], pin["rows"], pin["slot"]
    copiers = {G: dma.make_kernel(G, dma.N) for G in dma.GS}
    movers = {load: prims.make_rowmove(load) for load in (True, False)}
    copiers[dma.T](x, st)
    # ---- the probes' main path: each entry point once -----------------------------
    reset_launches()
    outs = [copiers[G](x, st) for G in dma.GS]
    moved = {load: movers[load](rows, slot) for load in (True, False)}
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if not launches["tile_copy"] or not launches["row_move"]:
        raise AssertionError(f"the probes launched {launches}")
    if not all(torch.equal(o, x) for o in outs):
        raise AssertionError("K11 with identity starts is not a copy")
    gidx = torch.arange(prims.N, device=dev) // prims.T * prims.T + slot.long()
    if not torch.equal(moved[True], rows[gidx]) or not torch.equal(moved[False][gidx], rows):
        raise AssertionError("K12's probe moves differ from indexing by global rows")
    del outs, moved

    def kernel_ms(prof, name):  # the kernel alone: not the starts' upload, not a zero fill
        return sum(us for n, us in prof["top"] if name in n) / 1e3

    res = {"launches": launches, "k11": {}, "k12": {}}
    nbytes = 2 * dma.N * dma.W * 4 + st.numel() * 4
    copy_out = torch.empty_like(x)
    lib = device_ms(lambda: copy_out.copy_(x))
    for G in dma.GS:
        prof = profile_device(lambda: copiers[G](x, st), reps=10)
        ms = kernel_ms(prof, "tile_copy")
        copies = bulk_copies(dma.N, G)
        res["k11"][G] = {"ms": ms, "gb_s": nbytes / ms / 1e6, "copies": copies,
                         "ns_per_copy": ms * 1e6 / copies, "bound_ms": bound_ms(nbytes),
                         "library_ms": lib, "wrapper_ms": prof["busy_us"] / 1e3}
        log(f"[probes] {card}: K11 tile copy n={dma.N} W={dma.W} T={dma.T} G={G}: kernel "
            f"{ms:.4f} ms ({prof['busy_us'] / 1e3:.4f} ms with the starts' upload and the "
            f"counter's memset), "
            f"{nbytes / ms / 1e6:.1f} GB/s, {copies} bulk copies -> {ms * 1e6 / copies:.2f} "
            f"ns/copy; bound {bound_ms(nbytes):.4f} ms ({nbytes} B); library copy_ {lib:.4f} ms; "
            f"CUDA-event span per back-to-back call {cuda_ms(lambda: copiers[G](x, st)):.4f} ms")
    # K11 at G = 32 and copy_ in turns within one profiled window, so that
    # the two readings share the card's state
    alt = profile_device(lambda: (copiers[32](x, st), copy_out.copy_(x)), reps=20)
    res["k11_alternating"] = {
        "ms": sum(us for n, us in alt["top"] if "tile_copy" in n) / 1e3,
        "library_ms": sum(us for n, us in alt["top"] if "tile_copy" not in n
                          and "HtoD" not in n and "Memset" not in n) / 1e3}
    log(f"[probes] {card}: K11 at G=32 and copy_ in turns, one profiled window of 20 pairs: "
        f"kernel {res['k11_alternating']['ms']:.4f} ms, copy_ "
        f"{res['k11_alternating']['library_ms']:.4f} ms a call; by kernel: "
        f"{device_parts(alt, top=3)}")
    nbytes = prims.N * 4 + 2 * prims.N * prims.W * 4
    into = torch.empty_like(rows)
    libs = {True: lambda: torch.index_select(rows, 0, gidx),
            False: lambda: into.index_copy_(0, gidx, rows)}
    for load, name in ((False, "P4 row-store"), (True, "P5 row-load")):
        prof = profile_device(lambda: movers[load](rows, slot), reps=10)
        ms = kernel_ms(prof, "row_move")
        lib = device_ms(libs[load])
        plain = device_ms(lambda: row_move_plain(rows, slot, prims.T, load))
        res["k12"][name] = {"ms": ms, "ns_per_row": ms * 1e6 / prims.N,
                            "bound_ms": bound_ms(nbytes), "library_ms": lib,
                            "wrapper_ms": prof["busy_us"] / 1e3, "plain_ms": plain}
        log(f"[probes] {card}: K12 {name} N={prims.N} W={prims.W} T={prims.T}: kernel "
            f"{ms:.4f} ms ({prof['busy_us'] / 1e3:.4f} ms the whole wrapper call"
            f"{', its zero fill included' if not load else ''}), "
            f"{ms * 1e6 / prims.N:.3f} ns/row; bound {bound_ms(nbytes):.4f} ms ({nbytes} B); "
            f"library {'index_select' if load else 'index_copy_'} with global rows {lib:.4f} ms; "
            f"plain version {plain:.4f} ms")
    # the probe modules' own entry points, as a user runs them
    if dma.main([]) != 0 or prims.main(["P4", "P5"]) != 0:
        raise AssertionError("a probe module's main failed")
    return res


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


ROUND_ROWS = 1_000_000
ROUND_MEM_ROWS = 100  # 65,536 cells, past K9's 38,399 a call: two rounds of 32,768


def plain_tiled_count(r, s, cfg, cap_mult: int) -> tuple:
    """The tiled join's attempt at `cap_mult` (field 1) through the kernels'
    plain versions on the same card tensors, round by round as the port
    runs it: the plain hash, each round's two stagings, all of the round's cell
    pairs in one plain K10 call (the pairs are independent, so the grouping
    into steps changes no count) and the plain gather; (mult, overflow)."""
    from database_technology_algorithms_tpu_torch.kernels import cells_plan
    from database_technology_algorithms_tpu_torch.kernels.hash_words import hash_words_plain
    from database_technology_algorithms_tpu_torch.kernels.member_mult import (
        member_multiplicity_cells_plain)
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
        stage_to_cells_plain)
    from database_technology_algorithms_tpu_torch.kernels.unpermute import (
        unpermute_gather_plain)
    from database_technology_algorithms_tpu_torch.ops.hash_join import _tile_layout

    ntiles, cap_b, cap_p, _ = _tile_layout(r.nrows, s.nrows, cfg.mem_rows, cap_mult)
    width = cells_plan.round_width(r.nrows, s.nrows, ntiles, cap_b, cap_p)
    hb = hash_words_plain([r.num]) & (ntiles - 1)
    hp = hash_words_plain([s.num]) & (ntiles - 1)
    mult = torch.zeros(s.nrows, dtype=torch.int32, device=s.num.device)
    overflow = 0
    for base in range(0, ntiles, width):
        bc, bn, _, ob = stage_to_cells_plain(hb - base, None, width, cap_b, [r.num], "none")
        pc, pn, slots, op = stage_to_cells_plain(hp - base, None, width, cap_p, [s.num], "slots")
        first = torch.cumsum(pn, 0, dtype=torch.int32) - pn
        out = torch.zeros(s.nrows, dtype=torch.int32, device=s.num.device)
        member_multiplicity_cells_plain([bc[0].view(width, cap_b)], bn,
                                        [pc[0].view(width, cap_p)], pn, None, out, first)
        mult += unpermute_gather_plain(slots, out, first, cap_p)
        overflow += int(ob) + int(op)
    return mult, overflow


def check_rounds(dev, card: str) -> dict:
    """``hash_join_count`` at 1M + 1M rows, field 1, under mem_rows=100:
    65,536 cells, which K9 stages in two rounds of 32,768.  The launch
    counters are set to 0 just before the run and read just after; its match
    mask and count are held against numpy and against the plain path on the
    same tensors (``plain_tiled_count`` at the attempt that succeeded, which
    must not overflow, where the attempt before it must); every K9 call of
    that attempt against its plain version."""
    from database_technology_algorithms_tpu_torch.config import EngineConfig
    from database_technology_algorithms_tpu_torch.kernels import (
        LAUNCHES, cells_plan, reset_launches)
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
        stage_to_cells, stage_to_cells_plain)
    from database_technology_algorithms_tpu_torch.ops.hash_join import (
        _tile_layout, hash_join_count)

    r_cols, s_cols = gen_pair(ROUND_ROWS)
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    cfg = EngineConfig(mem_rows=ROUND_MEM_ROWS)
    ntiles, cap_b, cap_p, group = _tile_layout(r.nrows, s.nrows, cfg.mem_rows)
    width = cells_plan.round_width(r.nrows, s.nrows, ntiles, cap_b, cap_p)
    if (ntiles, width) != (65536, 32768):
        raise AssertionError(f"the rounds' layout is {ntiles} cells in rounds of {width}")
    kb, kp = key_ids([r_cols, s_cols], 1)
    want = np.bincount(kb, minlength=int(max(kb.max(), kp.max())) + 1)[kp] > 0
    join = lambda: hash_join_count(r, s, 1, cfg)
    reset_launches()
    with _CountWarnings() as seen, recorded_calls("stage_cells", "stage_to_cells") as k9_calls:
        (matched, mult, nres), run_wall = timed(join)
    launches = dict(LAUNCHES)
    attempts = seen.n + 1
    rounds = ntiles // width
    expect = {"stage_cells": 2 * rounds * attempts, "unpermute_gather": rounds * attempts,
              "member_mult": ntiles // group * attempts, "hash_words": 2 * attempts}
    got_launches = {k: launches[k] for k in expect}
    if got_launches != expect or {c[0][2] for c in k9_calls} != {width}:
        raise AssertionError(f"65,536-cell join launched {got_launches}, expected {expect}, with "
                             f"K9 cells {sorted({c[0][2] for c in k9_calls})}")
    if int(nres) != int(want.sum()) or not np.array_equal(matched.cpu().numpy(), want):
        raise AssertionError(f"65,536-cell hash_join_count: nres {int(nres)}, numpy "
                             f"{int(want.sum())}")
    cap_mult = 1 << (attempts - 1)
    plain_mult, plain_ovf = plain_tiled_count(r, s, cfg, cap_mult)
    if plain_ovf or not torch.equal(plain_mult > 0, matched) or not torch.equal(
            (plain_mult > 0).to(torch.int32), mult):
        raise AssertionError(f"65,536-cell hash_join_count differs from the plain path at "
                             f"cap_mult {cap_mult} (plain overflow {plain_ovf})")
    if attempts > 1 and plain_tiled_count(r, s, cfg, cap_mult // 2)[1] == 0:
        raise AssertionError("the plain path does not overflow where the kernels did")
    k9_err = 0
    for args, kw in k9_calls[-2 * rounds:]:
        got = stage_to_cells(*args, **kw)
        plain_kw = {k: v for k, v in kw.items() if k != "in_range"}
        ref = stage_to_cells_plain(*args, **plain_kw)
        k9_err = max(k9_err, assert_same(
            f"K9 round of {args[2]} cells of {args[3]}",
            (*got[0], got[1], got[3].reshape(1)) + (() if got[2] is None else (got[2],)),
            (*ref[0], ref[1], ref[3].reshape(1)) + (() if ref[2] is None else (ref[2],))))
    del k9_calls
    prof = profile_device(join, reps=1, cpu=False)
    log(f"[over budget] {card}: hash_join_count {ROUND_ROWS}+{ROUND_ROWS} rows, field 1, "
        f"mem_rows {cfg.mem_rows}: {ntiles} cells of {cap_b} + {cap_p} rows, {group} pair a "
        f"step, staged in {rounds} rounds of {width} cells (K9 takes at most "
        f"{cells_plan.MAX_STAGE_BINS - 1}); {attempts} attempts (cap_mult {cap_mult}); nres "
        f"{int(nres)} == numpy == the plain path; K9's calls of the last attempt equal their "
        f"plain versions (max abs err {k9_err}); launches {got_launches}; host wall of the "
        f"synchronized call {run_wall:.1f} ms, device kernels {prof['busy_us'] / 1e3:.3f} ms "
        f"a call ({device_parts(prof)})")
    return {"ntiles": ntiles, "width": width, "attempts": attempts, "wall_ms": run_wall,
            "device_ms": prof["busy_us"] / 1e3, "launches": got_launches}


@contextlib.contextmanager
def recorded_extra_sorts():
    """The K1 (``view_sort``) and K5 (``words_sort``) calls made inside that
    carry extra words, as (wrapper name, args, kwargs).  The calls still
    launch their kernels."""
    with recorded_calls("radix_sort", "view_sort") as k1, \
            recorded_calls("words_sort", "words_sort") as k5:
        calls: list = []
        yield calls
    for name, recorded in (("view_sort", k1), ("words_sort", k5)):
        for args, kw in recorded:
            if sort_extras(name, args, kw):
                calls.append((name, args, kw))


def sort_extras(name: str, args, kw) -> tuple:
    """The extra words of a recorded K1 or K5 call."""
    import inspect

    module = importlib.import_module(f"{PKG}.kernels."
                                     + ("radix_sort" if name == "view_sort" else "words_sort"))
    bound = inspect.signature(getattr(module, name)).bind(*args, **kw)
    return tuple(bound.arguments.get("extra", ()))


def gather_words_reading(calls: list, run_prof: dict, card: str, what: str) -> dict:
    """``gather_words`` (``csrc/radix.cuh``), K1's and K5's gather of their
    extra words through the order, at the largest recorded call with extras:
    its device time a call (torch.profiler's gather_words events), the
    call's outputs against the wrapper's plain version (the extras outputs
    are what it writes), ``index_select`` of the same words through the
    same order (a yardstick), the byte bound (the order read, every extra
    word read and written once) and, from `run_prof`, its time and launches
    in the whole run."""
    name, args, kw = max(calls, key=lambda c: len(sort_extras(*c)) * sort_extras(*c)[0].numel())
    module = importlib.import_module(f"{PKG}.kernels."
                                     + ("radix_sort" if name == "view_sort" else "words_sort"))
    kernel, plain = getattr(module, name), getattr(module, name + "_plain")
    extras = sort_extras(name, args, kw)
    got, ref = kernel(*args, **kw), plain(*args, **kw)
    err = assert_same(f"{name} with {len(extras)} extra words ({what})",
                      flat_tensors(got), flat_tensors(ref))
    perm = got[1] if name == "view_sort" else got[0]
    n, k = perm.shape[0], len(extras)
    prof = profile_device(lambda: kernel(*args, **kw), reps=10)
    in_call = [e for e in prof["per_call"] if "gather_words" in e]
    ms = sum(us for nm, us in prof["top"] if "gather_words" in nm) / 1e3
    lib_ms = device_ms(lambda: [torch.index_select(w, 0, perm) for w in extras])
    nbytes = n * 4 + 2 * n * 4 * k
    least, bound_by = bound_of(nbytes, n * k)
    run_ms = sum(us for nm, us in run_prof["top"] if "gather_words" in nm) / 1e3
    run_launches = sum("gather_words" in e for e in run_prof["per_call"])
    log(f"[timing] {card}: gather_words ({what}: {name}, {n} rows, {k} extra words): device "
        f"time {ms:.4f} ms a call in {len(in_call)} launches, index_select of the same words "
        f"{lib_ms:.4f} ms, bound {least:.4f} ms by {bound_by} ({nbytes} B); the wrapper's "
        f"outputs against its plain version: max abs err {err}; in the whole run "
        f"{run_ms:.4f} ms in {run_launches} launches")
    return {"name": "gather_words", "what": what, "rows": n, "words": k, "ms": ms,
            "call_launches": len(in_call), "library_ms": lib_ms, "bound_ms": least,
            "bound_by": bound_by, "max_abs_err": err, "run_ms": run_ms,
            "launches": run_launches}


def phase_overbudget(dev, card: str) -> dict:
    from database_technology_algorithms_tpu_torch.config import DEFAULT_CONFIG, EngineConfig
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.kernels.hash_words import (
        hash_words, hash_words_plain)
    from database_technology_algorithms_tpu_torch.kernels.member_mult import (
        member_multiplicity_cells, member_multiplicity_cells_plain)
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
        stage_to_cells, stage_to_cells_plain)
    from database_technology_algorithms_tpu_torch.kernels.unpermute import (
        unpermute, unpermute_gather, unpermute_gather_plain)
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
    with recorded_calls("adj_equal", "adj_equal") as k6_calls:
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
    with recorded_extra_sorts() as extra_sorts:
        run(r, s)
    gather_chunk = gather_words_reading(extra_sorts, prof, card,
                                        f"over budget {rows}+{rows}, the largest call")
    del extra_sorts
    log(f"[over budget] {card}: host wall by step: distinct R {ms_dr:.1f} ms, distinct S "
        f"{ms_ds:.1f} ms, tiled join {ms_j:.1f} ms, chunked compaction {ms_c:.1f} ms; the whole "
        f"run again {run2_ms:.1f} ms; device kernels {prof['busy_us'] / 1e3:.1f} ms per run, "
        f"busy share of that wall {prof['busy_us'] / (run2_ms * 1e3):.3f}")
    for name, us in prof["top"][:12]:
        log(f"[over budget profile]   {us / 1e3:9.3f} ms  {name[:90]}")
    # K4 at the route's largest shape: a chunk of the chunked distinct's gather;
    # K3 on every compaction of the route's steps
    with recorded_take_fills() as k4_calls, recorded_compactions() as k3_calls:
        distinct(r, 1, cfg, active=r.valid)
    with recorded_compactions() as later_calls:
        hash_join_count(s_d, r_d, 1, cfg, build_count=nu_s, probe_count=nu_r)
        compact_rows_chunked(r_d, m_r, cfg)
    k3_calls += later_calls
    torch.cuda.synchronize()
    from database_technology_algorithms_tpu_torch.kernels.compact import (
        compact_words, compact_words_plain)
    k3_err = 0
    for keep, payload in k3_calls:
        got, want = compact_words(keep, payload), compact_words_plain(keep, payload)
        k3_err = max(k3_err, assert_same(
            f"K3 over budget, {keep.shape[0]} rows, {len(payload)} words",
            (got[0], *got[1]), (want[0], *want[1])))
    log(f"[kernels] K3 equals its plain version on the over-budget route's {len(k3_calls)} "
        f"compactions (rows {sorted({int(k.shape[0]) for k, _ in k3_calls})}): chunked "
        f"distinct R and the chunked compaction (the tiled join compacts in K10)")
    # the chunked compaction's 16M-row chunk: keep and the row index
    k3_chunk = compact_timing(
        max((c for c in k3_calls if isinstance(c[1][0], int)), key=lambda c: c[0].shape[0]),
        card, "over budget, the largest chunk of compact_rows_chunked")
    k3_chunk["launches"] = launches["compact"]
    k3_chunk["max_abs_err"] = k3_err
    del k3_calls
    k4_chunk = take_fill_timing(max(k4_calls, key=lambda c: c[0][4].shape[0]), card,
                                "over budget, the largest gather chunk of distinct R")
    k4_chunk["launches"] = launches["take_fill"]
    del k4_calls
    join = lambda: hash_join_count(s_d, r_d, 1, cfg, build_count=nu_s, probe_count=nu_r)
    reset_launches()
    with recorded_calls("stage_cells", "stage_to_cells") as k9_calls:
        join()
    torch.cuda.synchronize()
    row_maps = [c[0][5] if len(c[0]) > 5 else c[1].get("row_map", "slots") for c in k9_calls]
    if LAUNCHES["unpermute"] or not LAUNCHES["unpermute_gather"] or row_maps != ["none", "slots"]:
        raise AssertionError(f"the tiled join launched {dict(LAUNCHES)} with K9 row maps "
                             f"{row_maps}: expected K7's gather, no scatter, 'none' and 'slots'")
    from database_technology_algorithms_tpu_torch.kernels import cells_plan

    ntiles, cap_b, cap_p, group = _tile_layout(rows, rows, cfg.mem_rows)
    if cells_plan.round_width(rows, rows, ntiles, cap_b, cap_p) != ntiles:
        raise AssertionError(f"the {rows}+{rows} tiled join does not stage its {ntiles} "
                             f"cells in one round")
    log(f"[over budget] the tiled join alone: K9 with row maps {row_maps}, K7's gather "
        f"{LAUNCHES['unpermute_gather']} launch, the scatter {LAUNCHES['unpermute']}; "
        f"{ntiles} cells in one round")
    join_prof = profile_device(join, reps=3)
    join_wall = wall_ms(join, reps=5)
    log(f"[over budget] {card}: the tiled join alone: device kernels "
        f"{join_prof['busy_us'] / 1e3:.3f} ms a call, host wall {join_wall:.3f} ms (median of 5 "
        f"synchronized calls; {ms_j:.1f} ms in the step split above)")
    for name, us in join_prof["top"][:8]:
        log(f"[tiled join profile]   {us / 1e3:9.3f} ms  {name[:90]}")

    # ---- K8-K10 at this run's shapes: the build side of the tiled join ----------
    words = [s_d.num]
    hb = key_hash(s_d, 1) & (ntiles - 1)
    hp = key_hash(r_d, 1) & (ntiles - 1)
    # held against the plain versions on this run's inputs: the hash of both
    # sides, both stagings (row maps "none" and "si", the live counts of the
    # distinct steps, the in-range promise), every step's cell pairs
    at_path = {"hash_words": 0, "stage_cells": 0, "member_mult": 0, "unpermute_gather": 0}
    for side, w in (("build", [s_d.num]), ("probe", [r_d.num])):
        at_path["hash_words"] = max(at_path["hash_words"], assert_same(
            f"K8 {rows} {side} rows", (hash_words(w),), (hash_words_plain(w),)))
    bcells, bcnt, _, ovf_b = stage_to_cells(hb, None, ntiles, cap_b, words, "none", nu_s, True)
    pcells, pcnt, slots_p, ovf_p = stage_to_cells(hp, None, ntiles, cap_p, [r_d.num], "slots",
                                                  nu_r, True)
    want_b = stage_to_cells_plain(hb, None, ntiles, cap_b, words, "none", nu_s)
    want_p = stage_to_cells_plain(hp, None, ntiles, cap_p, [r_d.num], "slots", nu_r)
    at_path["stage_cells"] = max(
        assert_same(f"K9 {rows} build rows -> {ntiles} cells of {cap_b}, row map 'none'",
                    (*bcells, bcnt, ovf_b.reshape(1)), (*want_b[0], want_b[1], want_b[3].reshape(1))),
        assert_same(f"K9 {rows} probe rows -> {ntiles} cells of {cap_p}, row map 'slots'",
                    (*pcells, pcnt, ovf_p.reshape(1), slots_p),
                    (*want_p[0], want_p[1], want_p[3].reshape(1), want_p[2])))
    del want_b, want_p
    first = torch.cumsum(pcnt, 0, dtype=torch.int32) - pcnt
    mult_p = torch.zeros(rows, dtype=torch.int32, device=dev)
    for lo in range(0, ntiles, group):
        cells = ([w.view(ntiles, cap_b)[lo: lo + group] for w in bcells], bcnt[lo: lo + group],
                 [w.view(ntiles, cap_p)[lo: lo + group] for w in pcells], pcnt[lo: lo + group])
        got = torch.zeros(rows, dtype=torch.int32, device=dev)
        want = torch.zeros(rows, dtype=torch.int32, device=dev)
        member_multiplicity_cells(*cells, None, got, first[lo: lo + group])
        member_multiplicity_cells_plain(*cells, None, want, first[lo: lo + group])
        at_path["member_mult"] = max(at_path["member_mult"], assert_same(
            f"K10 pairs {lo} to {lo + group} of {cap_b} + {cap_p} rows", (got,), (want,)))
        member_multiplicity_cells(*cells, None, mult_p, first[lo: lo + group])
    del cells, got, want
    # K7's gather on this run's counts, against its plain version and against
    # the scatter through "si" that it replaced (the same staging)
    _, _, si_p, _ = stage_to_cells(hp, None, ntiles, cap_p, [r_d.num], "si", nu_r, True)
    mult_rows = unpermute_gather(slots_p, mult_p, first, cap_p, nu_r)
    at_path["unpermute_gather"] = max(
        assert_same(f"K7 gather of {rows} probe rows from {ntiles} cells of {cap_p}",
                    (mult_rows,), (unpermute_gather_plain(slots_p, mult_p, first, cap_p, nu_r),)),
        assert_same(f"K7 gather of {rows} probe rows against the scatter through si",
                    (mult_rows,), (unpermute(si_p, mult_p),)))
    if not torch.equal(mult_rows > 0, m_r):
        raise AssertionError("the over-budget run's gathered counts differ from its join's")
    log(f"[kernels] K8-K10 and K7's gather equal their plain versions on the over-budget run's "
        f"inputs: K8 on {rows} build and {rows} probe rows, K9 into {ntiles} cells of {cap_b} (row "
        f"map 'none') and of {cap_p} ('slots'), K10 on all {ntiles // group} steps of {group} "
        f"pairs, K7's gather of their counts (also equal to the scatter through 'si' and to the "
        f"join's match mask)")
    bw = [w.view(ntiles, cap_b)[:group] for w in bcells]
    pw = [w.view(ntiles, cap_p)[:group] for w in pcells]
    live_b, live_p = int(bcnt[:group].sum()), int(pcnt[:group].sum())
    live_r = int(nu_r)
    staged_p = int(pcnt.sum())
    nsteps = ntiles // group
    out_p = torch.zeros(rows, dtype=torch.int32, device=dev)
    log(f"[over budget] tiling: {ntiles} cells of {cap_b} + {cap_p} rows, {group} pairs a "
        f"step, {nsteps} steps; first step holds {live_b} + {live_p} live rows")
    k9_call = lambda: stage_to_cells(hp, None, ntiles, cap_p, [r_d.num], "slots", nu_r, True)
    k9_si = lambda: stage_to_cells(hp, None, ntiles, cap_p, [r_d.num], "si", nu_r, True)
    s_live = slots_p[:live_r].long()
    places = torch.where(s_live < ntiles * cap_p,
                         first.long()[(s_live // cap_p).clamp(max=ntiles - 1)] + s_live % cap_p,
                         0)
    del s_live
    specs = [
        dict(name="hash_words", source=f"{PKG}/csrc/hash_words.cu",
             replaces=f"{JAX_PKG}/ops/keys.py:110",
             kernel=lambda: hash_words(words), plain=lambda: hash_words_plain(words),
             nbytes=rows * (4 + 4),
             nops=rows * (4 * 3 + 8),  # xor, mask-shift, multiply a byte; the finalizer
             shape=f"{rows} rows, 1 key word (num) -> u32 hash"),
        dict(name="stage_cells", source=f"{PKG}/csrc/stage_cells.cu",
             replaces=f"{JAX_PKG}/ops/movement.py:354",
             kernel=k9_call,
             plain=lambda: stage_to_cells_plain(hp, None, ntiles, cap_p, [r_d.num], "slots",
                                                nu_r),
             # the live rows' dest and word read; every cell slot written once
             # (the staged words and the dead fill), the counts, and the slot
             # of every row (the rows past the live count: nparts * cap)
             nbytes=live_r * (4 + 4) + ntiles * cap_p * 4 + ntiles * 4 + rows * 4,
             nops=live_r * 8 + ntiles * cap_p,  # bucket, rank and slot a live row; a slot each
             shape=f"{rows} rows ({live_r} live) -> {ntiles} cells of {cap_p}, 1 key word, "
                   f"row map 'slots'"),
        dict(name="member_mult", source=f"{PKG}/csrc/member_mult.cu",
             replaces=f"{JAX_PKG}/ops/hash_join.py:256",
             kernel=lambda: member_multiplicity_cells(bw, bcnt[:group], pw, pcnt[:group], None,
                                                      out_p, first[:group]),
             plain=lambda: member_multiplicity_cells_plain(bw, bcnt[:group], pw, pcnt[:group],
                                                           None, out_p, first[:group]),
             # the live rows' key words, the two counts and the offsets read; a
             # count a live query row written (the compacted output)
             nbytes=(live_b + live_p) * 4 + group * 12 + live_p * 4,
             # a table hash (20) and about two probes of a compare each a live row
             nops=(live_b + live_p) * 24,
             shape=f"{group} pairs of {cap_b} + {cap_p} rows ({live_b} + {live_p} live), "
                   f"1 key word, compacted output; one of the run's {nsteps} steps"),
        dict(name="unpermute_gather", source=f"{PKG}/csrc/unpermute.cu",
             replaces=f"{JAX_PKG}/ops/hash_join.py:486",
             kernel=lambda: unpermute_gather(slots_p, mult_p, first, cap_p, nu_r),
             plain=lambda: unpermute_gather_plain(slots_p, mult_p, first, cap_p, nu_r),
             library=lambda: torch.index_select(mult_p, 0, places),
             # the live rows' slots and counts and the cells' first places
             # read; every probe row's count written
             nbytes=live_r * (4 + 4) + ntiles * 4 + rows * 4,
             nops=live_r * 6,  # a compare, a multiply-high, a shift, a multiply-add, two bounds
             shape=f"{rows} probe rows ({live_r} live) from {ntiles} cells of {cap_p}, K7's "
                   f"gather form; library: index_select of the live rows' precomputed places"),
    ]
    # K9's phases, one call: the count, the matrix's scan, the finish, the
    # place and the dead fill, as torch.profiler sees them
    k9_parts = profile_device(k9_call, reps=10)
    log(f"[timing] {card}: K9 phases at {rows} rows ({live_r} live, {staged_p} staged) -> "
        f"{ntiles} cells of {cap_p}, row map 'slots', a call: " + device_parts(k9_parts, top=8))
    k9_si_parts = profile_device(k9_si, reps=10)
    log(f"[timing] {card}: K9 in the 'si' form the tiled join no longer calls, a call: "
        f"{k9_si_parts['busy_us'] / 1e3:.4f} ms; " + device_parts(k9_si_parts, top=8))
    recs = []
    for sp in specs:
        reps = 2 if sp["name"] == "member_mult" else 3
        least_ms, bound_by = bound_of(sp["nbytes"], sp["nops"])
        rec = {
            "name": sp["name"], "route": "cuda", "source": sp["source"],
            "replaces": sp["replaces"], "launches": launches[sp["name"]],
            "max_abs_err": at_path[sp["name"]], "ms": None,
            "plain_ms": profile_device(sp["plain"], reps=reps)["busy_us"] / 1e3,
            "bound_ms": least_ms, "bound_by": bound_by,
            "library_ms": device_ms(sp["library"]) if sp.get("library") else None,
        }
        if sp["name"] == "stage_cells":
            rec["ms_si"] = k9_si_parts["busy_us"] / 1e3
        prof = profile_device(sp["kernel"], reps=10)
        rec["ms"] = prof["busy_us"] / 1e3
        lib = ("none (no single PyTorch call computes it)" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f} ms")
        log(f"[timing] {card}: {sp['name']} ({sp['shape']}): device time per call: kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library {lib}, bound "
            f"{rec['bound_ms']:.4f} ms by {bound_by} "
            f"({sp['nbytes']} B, {sp['nops']} operations); CUDA-event span per back-to-back "
            f"call: kernel {cuda_ms(sp['kernel'], reps=10):.4f} ms; its largest parts: "
            + device_parts(prof))
        recs.append(rec)
    k6_chunk = adj_timings(k6_calls, card, "over budget")
    for rec in k6_chunk:
        rec["launches"] = launches["adj_equal"]
    del bcells, pcells, bw, pw, hb, hp, r_d, s_d, m_r, out_p, first, slots_p, si_p, mult_p
    del places, mult_rows, k6_calls
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
    del r, s, matched

    # ---- 65,536 cells: K9's limit passed, the cells staged in two rounds ---------
    rounds = check_rounds(dev, card)
    return {"launches": launches, "recs": recs, "k4_chunk": k4_chunk, "k3_chunk": k3_chunk,
            "k6_chunk": k6_chunk, "gather_words": gather_chunk, "rounds": rounds}


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
# phase 8b: the external route (external.py) through the CLI, on files

EXT_NBLOCKS = 90_000  # 9M rows a file: R + S pass the default 16M-row budget
EXT_SMALL_NBLOCKS = 10_000  # 1M rows a file: fields 0, 2, 3 under --mem-blocks 1000
EXT_SMALL_MEM = 1000
EXT_CMDS = ("mergesort", "elimdup", "mergejoin", "hashjoin")


def external_kernels(cmd: str, field: int) -> list[str]:
    """The kernels a command of the external route must launch: every sort
    is ``sort_batch`` (K5 and K6, then K4); a distinct form adds K3; the
    semi-join's in-budget ``hash_join_count`` adds K2 and K7, and K1 at
    fields 0 and 1 (``packed_u32_sorts``).  Field 3's hash join keeps the
    build's duplicates, so it runs no distinct."""
    need = {"words_sort", "adj_equal", "take_fill"}
    if cmd in ("elimdup", "mergejoin") or (cmd == "hashjoin" and field != 3):
        need.add("compact")
    if cmd in ("mergejoin", "hashjoin"):
        need |= {"seg_scan", "unpermute"} | ({"radix_sort"} if field in (0, 1) else set())
    return sorted(need)


def external_oracle(cmd: str, r: dict, s: dict, field: int, mem_rows: int) -> tuple[dict, dict]:
    """numpy: (the JSON counters, the output file's rows as R or S row
    indices) of one command.  Keys compare as ``key_ids`` order them; a sort
    is stable, so among equal keys the first input row comes first."""
    kr, ks = key_ids([r, s], field)
    n = len(kr)
    segs = -(-n // mem_rows)
    if cmd == "mergesort":
        return ({"rows": n, "nsorted_segs": segs, "npasses": 2 if segs > 1 else 1},
                {"r": np.argsort(kr, kind="stable")})
    if cmd == "elimdup":
        first = np.unique(kr, return_index=True)[1]
        return {"rows": n, "nunique": len(first), "nsorted_segs": segs,
                "npasses": 2 if segs > 1 else 1}, {"r": first}
    if cmd == "mergejoin":
        want = oracle(r, s, field)
        return ({"nres": want["merge_nres"], "nunique_r": want["nunique_r"],
                 "nunique_s": want["nunique_s"]}, {"r": want["rows"]})
    mult = np.bincount(kr, minlength=int(max(kr.max(), ks.max())) + 1)[ks]
    order = np.argsort(ks, kind="stable")
    reps = mult[order] if field == 3 else (mult[order] > 0).astype(np.int64)
    return {"nres": int(reps.sum()), "output_order": "probe_key"}, {"s": np.repeat(order, reps)}


# the path's kernel wrappers, by launch counter: (module, wrapper, plain version)
EXT_KERNEL_PAIRS = {
    "radix_sort": ("radix_sort", "view_sort", "view_sort_plain"),
    "seg_scan": ("seg_scan", "seg_scan", "seg_scan_plain"),
    "compact": ("compact", "compact_words", "compact_words_plain"),
    "take_fill": ("take_fill", "take_fill", "take_fill_plain"),
    "words_sort": ("words_sort", "words_sort", "words_sort_plain"),
    "adj_equal": ("adj_equal", "adj_equal", "adj_equal_plain"),
    "unpermute": ("unpermute", "unpermute", "unpermute_plain"),
}
# the operators external.py calls on the card; the largest call of each is kept
EXT_OPERATORS = ("sort_batch", "distinct_sorted", "hash_join_count")


def op_rows(args) -> int:
    """Rows of the batches among an operator call's arguments."""
    return sum(a.nrows for a in args if hasattr(a, "nrows"))


class ExternalClock:
    """Where a run of the external route spends its host wall: the time of
    each external sort's pass 1 (from its start to its first read of a
    spilled segment), block decoding, spill writes and uploads (host
    columns to a device batch, packing included), by wrapping those
    functions for the span of a ``with``.  It also keeps the arguments of
    the largest call of each operator in ``EXT_OPERATORS`` (references to
    the run's own device batches: no copy, no launch) in ``captured``."""

    def __enter__(self):
        from database_technology_algorithms_tpu_torch import external as ext
        from database_technology_algorithms_tpu_torch.io import blockfile as bf

        self.acc = {"pass1": 0.0, "decode": 0.0, "spill writes": 0.0, "uploads": 0.0}
        self.captured = {}
        self.open_start = None
        self.patches = []
        clock = self

        def patch(owner, name, wrap):
            real = getattr(owner, name)
            self.patches.append((owner, name, real))
            setattr(owner, name, wrap(real))

        def summed(key):
            def wrap(real):
                def run(*a, **k):
                    t0 = time.perf_counter()
                    try:
                        return real(*a, **k)
                    finally:
                        clock.acc[key] += time.perf_counter() - t0
                return run
            return wrap

        def sort_starts(real):
            def run(*a, **k):
                clock.open_start = time.perf_counter()  # pass 1 runs without a yield
                yield from real(*a, **k)
            return run

        def pass1_ends(real):
            def run(*a, **k):
                if clock.open_start is not None:
                    clock.acc["pass1"] += time.perf_counter() - clock.open_start
                    clock.open_start = None
                return real(*a, **k)
            return run

        def keep_largest(op):
            def wrap(real):
                def run(*a, **k):
                    held = clock.captured.get(op)
                    if held is None or op_rows(a) > op_rows(held[0]):
                        clock.captured[op] = (a, k)
                    return real(*a, **k)
                return run
            return wrap

        patch(ext, "external_sort", sort_starts)
        patch(ext.SegmentStore, "open_segment", pass1_ends)
        patch(ext.SegmentStore, "read_segment", pass1_ends)
        patch(ext.SegmentStore, "write_segment", summed("spill writes"))
        patch(ext, "_to_batch", summed("uploads"))
        patch(bf, "decode_blocks_span", summed("decode"))
        for op in EXT_OPERATORS:
            patch(ext, op, keep_largest(op))
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self.patches):
            setattr(owner, name, real)


def flat_tensors(x) -> list:
    """The tensors of a kernel's result, in order (ints as 0-d tensors)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in flat_tensors(v)]
    return [torch.tensor(int(x))] if isinstance(x, int) else []


def check_captured_kernels(captured: dict, what: str) -> dict:
    """Run each captured operator call again on its own inputs, the run's
    device batches, with every kernel wrapper of ``EXT_KERNEL_PAIRS``
    held against its plain version on each call's arguments, bit for bit.
    Returns {kernel: (calls, largest rows, max abs err)}."""
    from database_technology_algorithms_tpu_torch import external as ext

    seen = {}

    def compare(name, wrapper, plain):
        def run(*a, **k):
            got = wrapper(*a, **k)
            if name == "unpermute":
                lo = a[2] if len(a) > 2 else k.get("lo", 0)
                m = a[3] if len(a) > 3 else k.get("m")
                want = plain(a[0], a[1], lo, a[0].shape[0] - lo if m is None else m)
            else:
                want = plain(*a, **k)
            err = assert_same(f"[external] {what}: {name}", flat_tensors(got), flat_tensors(want))
            rows = max((t.shape[0] for t in flat_tensors(a) if t.dim()), default=0)
            calls, most, worst = seen.get(name, (0, 0, 0))
            seen[name] = (calls + 1, max(most, rows), max(worst, err))
            return got
        return run

    patches = []
    for name, (mod_name, wname, pname) in EXT_KERNEL_PAIRS.items():
        module = importlib.import_module(f"{PKG}.kernels.{mod_name}")
        wrapper, plain = getattr(module, wname), getattr(module, pname)
        checked = compare(name, wrapper, plain)
        for m in [m for mod, m in sys.modules.items()
                  if mod.startswith(PKG) and getattr(m, wname, None) is wrapper]:
            patches.append((m, wname, wrapper))
            setattr(m, wname, checked)
    try:
        for op, (args, kw) in captured.items():
            getattr(ext, op)(*args, **kw)
        torch.cuda.synchronize()
    finally:
        for m, wname, wrapper in patches:
            setattr(m, wname, wrapper)
    return seen


def clean_cli(argv: list[str]) -> dict:
    """One CLI command with nothing wrapped and no profiler, the launch
    counters set to 0 just before and read just after: its exit code, JSON
    line, host wall (to the card's last result) and launches."""
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    rc, line = run_cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"rc": rc, "line": line, "wall": wall, "launches": dict(LAUNCHES)}


def traced_cli(argv: list[str]) -> dict:
    """One CLI command under torch.profiler and the ExternalClock: its exit
    code, JSON line, host wall under both, the clock's parts and captured
    operator calls, and the device's busy time (kernels, and the copies
    each way) with its largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with ExternalClock() as clock, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc, line = run_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = {"kernels": 0.0, "HtoD": 0.0, "DtoH": 0.0}
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        kind = next((k for k in ("HtoD", "DtoH") if k in ev.name), "kernels")
        dev_us[kind] += ev.device_time
        if kind == "kernels":
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"rc": rc, "line": line, "wall": wall, "clock": clock.acc,
            "captured": clock.captured, "dev_us": dev_us, "top": top}


def phase_external(dev, card: str) -> dict:
    """The external route on the card through the CLI (``external.py``): the
    automatic route of 9M + 9M-row files beyond the default 16M-row budget
    (``mergejoin``, ``hashjoin``), ``mergesort`` at its default
    ``--mem-blocks 10000`` and ``elimdup --mem-blocks 40000`` at field 1, then
    all four commands at fields 0, 2 and 3 on 1M-row files under
    ``--mem-blocks 1000``.  Each command runs once clean (no profiler, no
    wrapper: the host wall and the launch counters) and is checked against
    numpy, with its counters, a clean spill directory and the native reader.
    The 9M + 9M joins (the automatic route) run again under torch.profiler
    and the ExternalClock (the busy share and the wall's parts); that
    repeat also keeps the largest ``sort_batch`` (pass
    1), ``distinct_sorted`` and ``hash_join_count`` (a semi-join pair) call,
    and every kernel those calls launch is held against its plain version
    on the run's own inputs.  Returns {kernel: its largest error there}."""
    import tempfile

    from database_technology_algorithms_tpu_torch.config import DEFAULT_CONFIG
    from database_technology_algorithms_tpu_torch.io import native
    from database_technology_algorithms_tpu_torch.io.blockfile import read_blockfile_numpy
    from database_technology_algorithms_tpu_torch.io.generator import generate_pair_files

    t_phase = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("the native block-file library (native/dbtio.cpp) did not build")
    (ROOT / "build").mkdir(exist_ok=True)
    errs = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_external_") as tmp:
        tmp = Path(tmp)
        log(f"[external] free disk beside the checkout: "
            f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB")
        plans = [(EXT_NBLOCKS, [("mergejoin", 1, None), ("hashjoin", 1, None),
                                ("mergesort", 1, None), ("elimdup", 1, 40000)])]
        plans.append((EXT_SMALL_NBLOCKS, [(cmd, f, EXT_SMALL_MEM) for f in (0, 2, 3)
                                          for cmd in EXT_CMDS]))
        for nblocks, runs in plans:
            f1, f2 = str(tmp / f"r{nblocks}.bin"), str(tmp / f"s{nblocks}.bin")
            t0 = time.perf_counter()
            generate_pair_files(f1, f2, nblocks, seed=11)
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r = native.read_blockfile_native(f1)
            nat_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            r_np = read_blockfile_numpy(f1)
            np_s = time.perf_counter() - t0
            for k in r_np:
                if not np.array_equal(r[k], r_np[k]) or r[k].dtype != r_np[k].dtype:
                    raise AssertionError(f"native read of R differs from numpy's in {k}")
            del r_np
            s = native.read_blockfile_native(f2)
            n = len(r["recid"])
            log(f"[external] R and S, {n} rows each ({os.path.getsize(f1)} B a file), written "
                f"by generate_pair_files in {gen_s:.2f} s; R read back natively in {nat_s:.3f} s "
                f"({n / nat_s:,.0f} rows/s), by numpy in {np_s:.3f} s ({n / np_s:,.0f} rows/s): "
                f"equal columns")
            for cmd, field, mem_blocks in runs:
                work = tmp / f"work_{cmd}_{field}"
                work.mkdir()
                fo = str(tmp / "out.bin")
                files = [f1] if cmd in ("mergesort", "elimdup") else [f1, f2]
                argv = [cmd, *files, fo, "--field", str(field), "--workdir", str(work)]
                if mem_blocks:
                    argv += ["--mem-blocks", str(mem_blocks)]
                mem_rows = ((mem_blocks or (10000 if cmd == "mergesort" else 0)) * 100
                            or DEFAULT_CONFIG.mem_rows)
                auto = mem_blocks is None and cmd != "mergesort"
                what = (f"{cmd} field {field}, {n}" + (f" + {n}" if len(files) == 2 else "")
                        + " rows, " + ("automatic route" if auto else
                                       f"--mem-blocks {mem_blocks or 10000}"))
                res = clean_cli(argv)
                line = res["line"]
                if res["rc"] != 0:
                    raise AssertionError(f"[external] {what}: exit code {res['rc']}")
                want, rows = external_oracle(cmd, r, s, field, mem_rows)
                got = {k: line[k] for k in want}
                if got != want:
                    raise AssertionError(f"[external] {what}: {got}, numpy says {want}")
                if cmd != "mergesort":
                    if not line.get("external") or line["mem_rows"] != mem_rows:
                        raise AssertionError(f"[external] {what}: not the external route: {line}")
                    if line["peak_range_rows"] > mem_rows:
                        raise AssertionError(f"[external] {what}: peak_range_rows "
                                             f"{line['peak_range_rows']} > mem_rows {mem_rows}")
                back = native.read_blockfile_native(fo)
                (side, idx), = rows.items()
                src = r if side == "r" else s
                for k in ("recid", "num", "strs", "valid"):
                    if not np.array_equal(back[k], src[k][idx]):
                        raise AssertionError(f"[external] {what}: the output file's {k} "
                                             f"differs from numpy's")
                del back
                left = [str(p) for p in work.rglob("*") if p.is_file()]
                if left:
                    raise AssertionError(f"[external] {what}: the spill directory kept {left}")
                missing = [k for k in external_kernels(cmd, field) if res["launches"][k] == 0]
                if missing:
                    raise AssertionError(f"[external] {what}: never launched {missing}")
                rows_in = n * len(files)
                log(f"[external] {card}: {what}: {json.dumps(line)} == numpy (file and "
                    f"counters); host wall {res['wall']:.2f} s, {rows_in / res['wall']:,.0f} "
                    f"rows/s (no profiler, nothing wrapped); nsorted_segs "
                    f"{line['nsorted_segs']}, npasses {line.get('npasses', '-')}, bytes_host "
                    f"{line.get('bytes_host', '-')}")
                log(f"[external]   launches {res['launches']}")
                os.unlink(fo)
                if auto:  # the 9M-row joins: the 1M-row ones' repeats taught nothing more
                    prof = traced_cli(argv)
                    same = {k: v for k, v in prof["line"].items() if k != "wall_s"}
                    if prof["rc"] != 0 or same != {k: v for k, v in line.items() if k != "wall_s"}:
                        raise AssertionError(f"[external] {what}: the profiled repeat gave "
                                             f"{prof['rc']}, {prof['line']}")
                    os.unlink(fo)
                    busy = sum(prof["dev_us"].values()) / 1e6
                    clock = prof["clock"]
                    log(f"[external]   profiled repeat: host wall {prof['wall']:.2f} s under "
                        f"torch.profiler and the clock's wrappers; pass 1 {clock['pass1']:.2f} s, "
                        f"pass 2 and the join {prof['wall'] - clock['pass1']:.2f} s; decode "
                        f"{clock['decode']:.2f} s, spill writes {clock['spill writes']:.2f} s, "
                        f"uploads {clock['uploads']:.2f} s; device busy {busy:.3f} s (kernels "
                        f"{prof['dev_us']['kernels'] / 1e6:.3f}, copies to the card "
                        f"{prof['dev_us']['HtoD'] / 1e6:.3f}, back "
                        f"{prof['dev_us']['DtoH'] / 1e6:.3f}), share {busy / prof['wall']:.3f} of "
                        f"the profiled wall, {busy / res['wall']:.3f} of the clean one")
                    log(f"[external]   largest kernels, ms: " + device_parts(prof))
                    cat = sum(us for k, us in prof["top"] if "CatArrayBatchedCopy" in k)
                    log(f"[external]   torch.cat kernels (RecordBatch.concat of the "
                        f"semi-join's two sides, ops/hash_join.py _fused_matched_mult): "
                        f"{cat / 1e3:.2f} ms")
                    shapes = {op: op_rows(a) for op, (a, _) in prof["captured"].items()}
                    seen = check_captured_kernels(prof["captured"], what)
                    ran = {k for k, v in res["launches"].items() if v}
                    if ran - set(seen):
                        raise AssertionError(
                            f"[external] {what}: the run launched {sorted(ran - set(seen))}, "
                            f"which the captured calls {shapes} never reached")
                    for k, (_, _, err) in seen.items():
                        errs[k] = max(errs.get(k, 0), err)
                    log(f"[kernels] {what}: the largest call of each operator, by rows "
                        f"{shapes}, run again on the run's own device batches: every "
                        f"kernel equals its plain version (calls, largest rows, max abs "
                        f"err): {seen}")
                    del prof
            del r, s
            os.unlink(f1)
            os.unlink(f2)
    log(f"[external] the phase took {time.perf_counter() - t_phase:.1f} s")
    return errs


# ---------------------------------------------------------------------------
# phase 6: kernel timings at the main path's shapes


# ---------------------------------------------------------------------------
# phase 9: selection filter and group-by aggregate (K13), field-3 expansion (K14)

AGG_NBLOCKS = 167_772  # 16,777,200 rows a table, just under EngineConfig.mem_rows
AGG_SMALL_NBLOCKS = NBLOCKS  # fields 0, 2 and 3 at 1M rows
AGG_SLICES = 4  # the two-phase form: local aggregates of 4 slices, then the combine
ZIPF_A = 1.2  # the skewed table: a few keys hold most rows
F3_BUILD_KEYS, F3_PROBE_KEYS = 2000, 40_000  # field 3: num ranges; 1-letter strings
AGG_NAMES = ("count", "sum", "min", "max")
AGG_IDENTITY = (0, 0, -1, 0)  # past n_groups: 0, 0, U32_MAX as int32 bits, 0
FILTER_KERNELS = ("compact", "take_fill")
F3_KERNELS = ("seg_scan", "expand_sources", "take_fill")


def agg_kernels(field: int) -> tuple:
    """What one group_aggregate at `field` must launch (gather route); K13
    finds its group ids itself, so no K2."""
    sort = ("radix_sort",) if field in (0, 1) else ("words_sort", "adj_equal")
    return sort + ("run_aggregate", "compact", "take_fill")


def agg_table(nblocks: int, seed: int, zipf_a=None) -> dict:
    """A generated table at the bench's key range with every seventh row's
    valid flag cleared; its 5-letter strings kept at 8 bytes, the stored
    width."""
    from database_technology_algorithms_tpu_torch.io.generator import generate_columns

    rows = nblocks * 100
    cols = generate_columns(nblocks, seed=seed, key_range=max(3 * rows // 10, 1), zipf_a=zipf_a)
    cols["strs"] = np.ascontiguousarray(cols["strs"][:, :8])
    cols["valid"][::7] = False
    return cols


def u32_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def agg_result_tensors(res) -> list:
    """The four aggregate columns and n_groups of a run_aggregate result."""
    aggs, ng = res
    return [aggs[k] for k in AGG_NAMES] + [ng.reshape(1)]


def check_launched(launches: dict, kernels, what: str) -> None:
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: never launched {missing} ({launches})")


def check_filtered(out, n_kept, cols: dict, kept: np.ndarray, what: str) -> None:
    """The filter's count and kept rows against the numpy mask, in row order."""
    from database_technology_algorithms_tpu_torch.batch import as_u32

    n = int(n_kept)
    if n != len(kept):
        raise AssertionError(f"{what}: {n} rows kept, numpy keeps {len(kept)}")
    for name in ("recid", "num"):
        if not np.array_equal(u32_host(getattr(out, name)[:n]), cols[name][kept]):
            raise AssertionError(f"{what}: kept {name} differ from numpy's")
    words = cols["strs"][kept].view(">u4").astype(np.uint64).sum() % (1 << 32)
    if int(as_u32(out.strw[:n]).sum()) % (1 << 32) != int(words):
        raise AssertionError(f"{what}: kept strings differ from numpy's")
    if not bool(out.valid[:n].all()) or bool(out.valid[n:].any()) or bool(out.recid[n:].any()):
        raise AssertionError(f"{what}: kept rows not valid, or rows past the count not zero")


def agg_oracle(cols: dict, rows: np.ndarray, field: int) -> dict:
    """numpy: the groups of `rows` (indices into cols) by key, in key order:
    count, u32 sum (u64 sums mod 2^32), unsigned min and max of num, and the
    first row of each group."""
    sub = {k: v[rows] for k, v in cols.items()}
    ids = key_ids([sub], field)[0]
    keys, first, counts = np.unique(ids, return_index=True, return_counts=True)
    order = np.argsort(ids, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    num = sub["num"][order].astype(np.uint64)
    if len(keys) == 0:
        sums = mins = maxs = np.zeros(0, np.uint64)
    else:
        sums = np.add.reduceat(num, starts) % (1 << 32)
        mins, maxs = np.minimum.reduceat(num, starts), np.maximum.reduceat(num, starts)
    return {"n_groups": len(keys), "count": counts.astype(np.uint32),
            "sum": sums.astype(np.uint32), "min": mins.astype(np.uint32),
            "max": maxs.astype(np.uint32), "rep_recid": sub["recid"][first]}


def check_aggregate(res, want: dict, what: str) -> None:
    reps, aggs, ng = res
    ng = int(ng)
    if ng != want["n_groups"]:
        raise AssertionError(f"{what}: {ng} groups, numpy has {want['n_groups']}")
    for k, fill in zip(AGG_NAMES, AGG_IDENTITY):
        if not np.array_equal(u32_host(aggs[k][:ng]), want[k]):
            raise AssertionError(f"{what}: {k} differs from numpy's")
        if bool((aggs[k][ng:] != fill).any()):
            raise AssertionError(f"{what}: {k} past n_groups is not {fill}")
    if not np.array_equal(u32_host(reps.recid[:ng]), want["rep_recid"]):
        raise AssertionError(f"{what}: representative rows differ from numpy's first rows")
    if not bool(reps.valid[:ng].all()) or bool(reps.valid[ng:].any()):
        raise AssertionError(f"{what}: representatives' valid flags are wrong")


def two_phase(batch, n_kept, field: int):
    """The local/global split of the distributed plan on one card, without
    the exchange: group_aggregate on AGG_SLICES slices of the live rows, each
    slice's live reps and partials concatenated in slice order, then
    combine_group_aggregate_impl."""
    from database_technology_algorithms_tpu_torch.batch import RecordBatch
    from database_technology_algorithms_tpu_torch.ops.aggregate import (
        combine_group_aggregate_impl, group_aggregate)

    bounds = np.linspace(0, int(n_kept), AGG_SLICES + 1).astype(int)
    reps, parts = [], [[] for _ in AGG_NAMES]
    for a, b in zip(bounds[:-1], bounds[1:]):
        r, aggs, ng = group_aggregate(batch.slice(int(a), int(b - a)), field)
        ng = int(ng)
        reps.append(r.slice(0, ng))
        for j, k in enumerate(AGG_NAMES):
            parts[j].append(aggs[k][:ng])
    return combine_group_aggregate_impl(RecordBatch.concat(reps), field,
                                        tuple(torch.cat(p) for p in parts))


def same_aggregate(got, want, what: str) -> None:
    """Two (reps, aggs, n_groups) results agree on the live groups."""
    ng = int(want[2])
    if int(got[2]) != ng:
        raise AssertionError(f"{what}: {int(got[2])} groups, the single pass has {ng}")
    for k in AGG_NAMES:
        if not torch.equal(got[1][k][:ng], want[1][k][:ng]):
            raise AssertionError(f"{what}: {k} differs from the single pass")
    for c in ("recid", "num", "strw", "valid"):
        if not torch.equal(getattr(got[0], c)[:ng], getattr(want[0], c)[:ng]):
            raise AssertionError(f"{what}: representatives' {c} differ from the single pass")


def run_measured(name: str, fn, kernels, card: str, reps: int = 5) -> tuple:
    """One run with the launch counters set to 0 just before and read just
    after (the main path's count), then its host wall (median of `reps`
    synchronized runs) and device time (torch.profiler)."""
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    check_launched(launches, kernels, name)
    wall = wall_ms(fn, reps=reps)
    prof = profile_device(fn, reps=3)
    log(f"[aggregate] {card}: {name}: host wall {wall:.4f} ms (median of {reps} synchronized "
        f"runs), device {prof['busy_us'] / 1e3:.4f} ms a run ({device_parts(prof)}); launches "
        + ", ".join(f"{k} {launches[k]}" for k in kernels))
    return out, {"wall_ms": wall, "device_ms": prof["busy_us"] / 1e3,
                 "launches": {k: launches[k] for k in kernels}}


def k13_library(active_s, adj, vals):
    """A yardstick for K13, never called by the port: group ids by a
    cumsum, then bincount and three scatter_reduce_ on int64 copies (the
    unsigned order), inactive rows into a dump slot."""
    from database_technology_algorithms_tpu_torch.batch import as_u32

    n = active_s.shape[0]
    gid = torch.cumsum(active_s & ~adj, 0) - 1
    idx = torch.where(active_s, gid, n)
    v = as_u32(vals[-1])
    count = torch.bincount(idx, minlength=n + 1)
    total = torch.zeros(n + 1, dtype=torch.int64, device=v.device).scatter_reduce_(0, idx, v, "sum")
    lo = torch.full((n + 1,), 0xFFFFFFFF, dtype=torch.int64, device=v.device).scatter_reduce_(
        0, idx, v, "amin")
    hi = torch.zeros(n + 1, dtype=torch.int64, device=v.device).scatter_reduce_(0, idx, v, "amax")
    return count, total, lo, hi


def k13_prefilled(active_s, adj, vals):
    """K13's entry on an output filled with 0x5A5A5A5A, n_groups with -1 and
    its scratch with 0xFFFFFFFF before the call: a word that the kernel
    left to a pre-fill, or a record that it read before its memset, would
    show."""
    from database_technology_algorithms_tpu_torch.kernels import _lib
    from database_technology_algorithms_tpu_torch.kernels.run_aggregate import agg_scratch_words

    n, dev = active_s.shape[0], active_s.device
    out = torch.full((4, n), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    n_groups = torch.full((), -1, dtype=torch.int32, device=dev)
    words = agg_scratch_words(n)
    scratch = torch.full((words,), -1, dtype=torch.int32, device=dev)
    err = _lib.library().dbt_run_aggregate(
        active_s.data_ptr(), adj.data_ptr(), _lib.ptr_array(vals), len(vals), n, out.data_ptr(),
        n_groups.data_ptr(), scratch.data_ptr(), words, _lib.stream_of(active_s))
    _lib.raise_on_error(err, "run_aggregate")
    return dict(zip(AGG_NAMES, out)), n_groups


def k13_edges(g, dev) -> list:
    """(what, active_s, adj, vals) at K13's tile edges
    (tests/test_torch_aggregate.py's cases, at the kernel's own tile): a
    warp's 512 rows, a tile, 40 tiles (look-backs across windows of 32)."""
    from database_technology_algorithms_tpu_torch.kernels.run_aggregate import TILE_ROWS

    span, block = TILE_ROWS, 512
    cases = []
    for n, kind in ((0, "random"), (1, "random"), (31, "random"), (32, "random"),
                    (33, "random"), (block - 1, "random"), (block + 1, "random"),
                    (span - 1, "random"), (span, "random"), (span + 1, "random"),
                    (40 * span + 3, "sparse"), (3 * span + 17, "sparse"),
                    (4 * span, "group over spans"), (4 * span, "starts on a span's last row"),
                    (5 * span, "every row a group"), (5 * span + 3, "one group"),
                    (4 * span, "all inactive"), (70_001, "random"), (ROWS, "random"),
                    (ROWS, "sparse")):
        starts = np.zeros(n, bool)
        if kind == "random":
            starts = g.random(n) < 0.2
        elif kind == "sparse":
            starts = g.random(n) < 0.01
        elif kind == "group over spans":
            starts = g.random(n) < 0.3
            starts[span // 2 + 1: span // 2 + 2 * span + 41] = False
        elif kind == "starts on a span's last row":
            starts[::span // 4] = True
            starts[span - 1::span] = True
            starts[span::span] = False
        elif kind == "every row a group":
            starts[:] = True
        if n:
            starts[0] = True
        active = np.ones(n, bool)
        if kind in ("random", "sparse") and n > 2:
            active[n - min(span // 2 + 5, n // 2):] = False  # the inactive tail
        if kind == "all inactive":
            active[:] = False
        adj = ~starts
        tail = ~active
        adj[tail] = g.random(int(tail.sum())) < 0.5
        for m in (1, 4):
            vals = g.integers(0, 2**32, size=(m, n), dtype=np.uint64).astype(np.uint32)
            vals[0, ::3] |= np.uint32(1 << 31)
            cases.append((f"n={n} {kind} {m} measure{'s' * (m > 1)}",
                          torch.from_numpy(active).to(dev), torch.from_numpy(adj).to(dev),
                          tuple(torch.from_numpy(v.view(np.int32)).to(dev) for v in vals)))
    return cases


def k14_edges(g, dev) -> list:
    """(what, c, total, cap) at K14's edges: a heavy row's outputs over many
    merge blocks, zero runs longer than a block, block starts on a row's end
    and on a tie (c[j] = i) among them."""
    from database_technology_algorithms_tpu_torch.kernels import scan_plan

    nv = scan_plan.EXPAND_THREADS * scan_plan.EXPAND_ITEMS
    cases = []
    for nprobe, kind in ((0, "none"), (1, "random"), (7, "random"), (1000, "zero at both ends"),
                         (1000, "no output"), (1000, "one row holds all"),
                         (1000, "first row holds all"), (1000, "last row holds all"),
                         (100_000, "random"), (ROWS, "random"), (ROWS, "one row holds all"),
                         (ROWS, "zero runs longer than a block"), (3 * nv, "every row once")):
        mult = g.integers(0, 4, size=nprobe).astype(np.int32)
        if kind == "zero runs longer than a block":
            mult[nprobe // 4:nprobe // 4 + 3 * nv + 1] = 0
            mult[nprobe // 2:nprobe // 2 + 40 * nv] = 0
        elif kind == "every row once":  # every block starts on a tie, entry c[j] = i first
            mult[:] = 1
        elif kind == "zero at both ends":
            mult[:nprobe // 5] = 0
            mult[-nprobe // 5:] = 0
        elif kind == "no output":
            mult[:] = 0
        elif kind.endswith("holds all"):
            mult[:] = 0
            mult[{"one": nprobe // 3, "first": 0, "last": -1}[kind.split()[0]]] = (
                3 * nprobe if nprobe < ROWS else nprobe)
        m = torch.from_numpy(mult).to(dev)
        c = torch.cumsum(m, 0, dtype=torch.int32)
        total = c[-1] if nprobe else torch.zeros((), dtype=torch.int32, device=dev)
        t = int(total)
        for cap in sorted({0, t // 2, t, t + 37}):
            cases.append((f"nprobe={nprobe} {kind} total={t} cap={cap}", c, total, cap))
    return cases


def phase_aggregate(dev, card: str) -> dict:
    """BASELINE's selection filter + hash aggregate over one table at the
    default budget's edge (16,777,200 rows, uniform and Zipf keys, field 1),
    the two-phase combine, fields 0, 2 and 3 at 1M rows, and the field-3
    device expansion; K13 and K14 against their plain versions at their edges
    and on the runs' own inputs, timed beside their yardsticks."""
    from database_technology_algorithms_tpu_torch.kernels.expand_sources import (
        expand_sources, expand_sources_plain)
    from database_technology_algorithms_tpu_torch.kernels.run_aggregate import (
        run_aggregate, run_aggregate_plain)
    from database_technology_algorithms_tpu_torch.ops import filter as F
    from database_technology_algorithms_tpu_torch.ops.aggregate import group_aggregate
    from database_technology_algorithms_tpu_torch.ops.hash_join import (
        hash_join_count, materialize_field3, materialize_field3_device)

    t_phase = time.time()
    g = np.random.default_rng(12)
    errs = {"run_aggregate": 0, "expand_sources": 0}
    # ---- K13 and K14 at their edges ------------------------------------------
    for what, active, adj, vals in k13_edges(g, dev):
        want = agg_result_tensors(run_aggregate_plain(active, adj, vals))
        errs["run_aggregate"] = max(errs["run_aggregate"], assert_same(
            f"K13 {what}", agg_result_tensors(run_aggregate(active, adj, vals)), want))
        errs["run_aggregate"] = max(errs["run_aggregate"], assert_same(
            f"K13 {what}, output and scratch filled with other bits first",
            agg_result_tensors(k13_prefilled(active, adj, vals)), want))
    n = 2 * BIG_ROWS  # one key over every row: one group open across 4096 tiles
    one = (torch.ones(n, dtype=torch.bool, device=dev),
           torch.ones(n, dtype=torch.bool, device=dev).index_fill_(0, torch.zeros(
               1, dtype=torch.long, device=dev), False),
           (torch.full((n,), -7, dtype=torch.int32, device=dev),))
    errs["run_aggregate"] = max(errs["run_aggregate"], assert_same(
        f"K13 one key over {n} rows", agg_result_tensors(run_aggregate(*one)),
        agg_result_tensors(run_aggregate_plain(*one))))
    one_ms = device_ms(lambda: run_aggregate(*one))
    del one
    for what, c, total, cap in k14_edges(g, dev):
        errs["expand_sources"] = max(errs["expand_sources"], assert_same(
            f"K14 {what}", (expand_sources(c, total, cap),),
            (expand_sources_plain(c, total, cap),)))
    torch.cuda.synchronize()
    log(f"[kernels] K13 and K14 equal their plain versions at their edges (K13: a warp's "
        f"rows, a tile, 40 tiles, 1 and 4 measures, bit 31 set, also on an output and scratch "
        f"filled with other bits first; one key over {n} rows, {one_ms:.4f} ms; K14: "
        f"no probe rows, no output, one row holding all (also of {ROWS} outputs over many merge "
        f"blocks), zero runs longer than a block, every row once (block starts on ties), "
        f"cap 0, total//2, total, total+37)")

    # ---- 16M-row tables at field 1 ----------------------------------------------
    runs, captured = {}, {}
    for table, seed, zipf in (("uniform", 71, None), ("zipf", 72, ZIPF_A)):
        cols = agg_table(AGG_NBLOCKS, seed, zipf)
        rows = len(cols["num"])
        t = to_batch(cols, dev)
        live_num = np.sort(cols["num"][cols["valid"]])
        if zipf is None:
            lo, hi = int(live_num[len(live_num) // 4]), int(live_num[3 * len(live_num) // 4])
        else:
            lo, hi = 0, int(live_num[len(live_num) // 2]) + 1
        pred = F.pred_and(F.pred_valid(), F.pred_num_range(lo, hi))
        mask = cols["valid"] & (cols["num"] >= lo) & (cols["num"] < hi)
        kept = np.flatnonzero(mask)
        what = f"{table}, {rows} rows, field 1"
        (filtered, n_kept), runs[(table, "filter")] = run_measured(
            f"filter_batch {what}, num in [{lo}, {hi})", lambda: F.filter_batch(t, pred),
            FILTER_KERNELS, card)
        check_filtered(filtered, n_kept, cols, kept, f"filter {what}")
        res, runs[(table, "aggregate")] = run_measured(
            f"group_aggregate {what}, {len(kept)} live rows",
            lambda: group_aggregate(filtered, 1, count=n_kept), agg_kernels(1), card)
        want = agg_oracle(cols, kept, 1)
        check_aggregate(res, want, f"group_aggregate {what}")
        both_phases, runs[(table, "two-phase")] = run_measured(
            f"two-phase aggregate {what}, {AGG_SLICES} slices", lambda: two_phase(
                filtered, n_kept, 1), agg_kernels(1), card, reps=3)
        same_aggregate(both_phases, res, f"two-phase {what}")
        top = int(np.argmax(want["count"]))
        log(f"[aggregate] {what}: {len(kept)} rows kept (numpy: the same rows), "
            f"{want['n_groups']} groups (numpy: the same groups, counts, sums, mins, maxes and "
            f"first rows); the largest group {int(want['count'][top])} rows; the two-phase "
            f"form equals the single pass")
        if table == "uniform":  # K1's gather of its extra words inside group_aggregate
            agg_prof = profile_device(lambda: group_aggregate(filtered, 1, count=n_kept),
                                      reps=3)
            with recorded_extra_sorts() as extra_sorts:
                group_aggregate(filtered, 1, count=n_kept)
            gather_agg = gather_words_reading(extra_sorts, agg_prof, card,
                                              f"group_aggregate {what}")
            del extra_sorts
        with recorded_calls("run_aggregate", "run_aggregate") as calls:
            group_aggregate(filtered, 1, count=n_kept)
            two_phase(filtered, n_kept, 1)
        captured[table] = calls[0][0]
        captured[f"{table} combine"] = calls[-1][0]
        del t, filtered, res, both_phases, calls
    # ---- fields 0, 2 and 3 at 1M rows --------------------------------------------
    cols = agg_table(AGG_SMALL_NBLOCKS, 73)
    t = to_batch(cols, dev)
    k = max(3 * len(cols["num"]) // 10, 1)
    pred = F.pred_and(F.pred_valid(), F.pred_num_range(k // 4, 3 * k // 4))
    kept = np.flatnonzero(cols["valid"] & (cols["num"] >= k // 4) & (cols["num"] < 3 * k // 4))
    filtered, n_kept = F.filter_batch(t, pred)
    check_filtered(filtered, n_kept, cols, kept, "filter, 1M rows")
    for field in (0, 2, 3):
        what = f"uniform, {len(cols['num'])} rows, field {field}"
        res, runs[("1M", f"field {field}")] = run_measured(
            f"group_aggregate {what}", lambda: group_aggregate(filtered, field, count=n_kept),
            agg_kernels(field), card)
        check_aggregate(res, agg_oracle(cols, kept, field), f"group_aggregate {what}")
    del t, filtered, res
    # ---- field 3's device expansion ------------------------------------------------
    b_cols = generate_f3(AGG_SMALL_NBLOCKS, 74, F3_BUILD_KEYS)
    p_cols = generate_f3(AGG_SMALL_NBLOCKS, 75, F3_PROBE_KEYS)
    build, probe = to_batch(b_cols, dev), to_batch(p_cols, dev)
    matched, mult, nres = hash_join_count(build, probe, 3)
    total = int(nres)
    host = materialize_field3(probe, matched, mult)
    f3 = {}
    for cap in (total, total // 2):
        what = f"materialize_field3_device, {probe.nrows} probe rows, cap {cap} of {total}"
        (out, got_total), runs[("field 3", f"cap {cap}")] = run_measured(
            what, lambda: materialize_field3_device(probe, mult, cap), F3_KERNELS, card)
        live = min(total, cap)
        if int(got_total) != total or out.nrows != cap:
            raise AssertionError(f"{what}: total {int(got_total)}, {out.nrows} rows")
        for c in ("recid", "num", "strw", "valid"):
            if not torch.equal(getattr(out, c)[:live], getattr(host, c)[:live]):
                raise AssertionError(f"{what}: {c} differs from the host materialize_field3")
            if bool(getattr(out, c)[live:].any()):
                raise AssertionError(f"{what}: {c} past the total or cap is not zero")
        f3[cap] = out
    log(f"[aggregate] field 3: {total} output rows from {int(matched.sum())} matched probe rows, "
        f"largest multiplicity {int(mult.max())}; cap {total} and {total // 2} equal the host "
        f"materialize_field3 up to min(total, cap), zero past it, the total whole")
    with recorded_calls("expand_sources", "expand_sources") as calls:
        materialize_field3_device(probe, mult, total)
    captured["field 3"] = calls[0][0]
    del f3, host, build, probe
    # ---- K13 and K14 on the runs' own inputs -------------------------------------
    for what, args in captured.items():
        if what == "field 3":
            got, want = (expand_sources(*args),), (expand_sources_plain(*args),)
            name = "expand_sources"
        else:
            got = agg_result_tensors(run_aggregate(*args))
            want = agg_result_tensors(run_aggregate_plain(*args))
            name = "run_aggregate"
        errs[name] = max(errs[name], assert_same(f"{name} on the {what} run's inputs", got, want))
    torch.cuda.synchronize()
    log(f"[kernels] K13 equals its plain version on the uniform, Zipf and combine runs' own "
        f"inputs, K14 on the field-3 run's; max abs err {errs}")
    recs = [k13_record(captured, runs, errs, card), k14_record(captured, runs, errs, card)]
    log(f"[aggregate] the phase took {time.time() - t_phase:.1f} s")
    return {"recs": recs, "runs": runs, "gather_words": gather_agg}


def generate_f3(nblocks: int, seed: int, key_range: int) -> dict:
    """A table whose field-3 keys repeat: num in [0, key_range), 1-letter
    strings, so that a build of a small range gives probe rows tens of
    matches."""
    from database_technology_algorithms_tpu_torch.io.generator import generate_columns

    cols = generate_columns(nblocks, seed=seed, key_range=key_range, str_len=1,
                            plant_hola=False)
    cols["strs"] = np.ascontiguousarray(cols["strs"][:, :8])
    return cols


def k13_record(captured: dict, runs: dict, errs: dict, card: str) -> dict:
    from database_technology_algorithms_tpu_torch.kernels.run_aggregate import (
        run_aggregate, run_aggregate_plain)

    def timing(args):
        n, m = args[0].shape[0], len(args[2])
        nbytes = n * (2 + 4 * m) + 16 * n + 4  # flags and measures in; four columns out
        bound, by = bound_of(nbytes, 4 * n)
        return {"ms": device_ms(lambda: run_aggregate(*args)),
                "plain_ms": device_ms(lambda: run_aggregate_plain(*args)),
                "library_ms": device_ms(lambda: k13_library(*args)),
                "bound_ms": bound, "bound_by": by, "rows": n, "measures": m}

    rec = {"name": "run_aggregate", "route": "cuda", "source": f"{PKG}/csrc/run_aggregate.cu",
           "replaces": f"{JAX_PKG}/ops/aggregate.py:46",
           "launches": runs[("uniform", "aggregate")]["launches"]["run_aggregate"],
           "max_abs_err": errs["run_aggregate"]}
    shapes = {}
    for what in ("uniform", "zipf", "uniform combine"):
        shapes[what] = timing(captured[what])
        s = shapes[what]
        log(f"[timing] {card}: run_aggregate ({what}: {s['rows']} sorted rows, {s['measures']} "
            f"measure(s)): device time per call (the memset, the pass, the identity tail): kernel "
            f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, library (cumsum, bincount, 3 "
            f"scatter_reduce_) {s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms")
    args = captured["uniform"]
    prof = profile_device(lambda: run_aggregate(*args), reps=10)
    kernels = [k for k in prof["per_call"] if "Memset" not in k]
    if (len(prof["per_call"]) - len(kernels) != 1 or len(kernels) != 2
            or not any("run_aggregate_kernel" in k for k in kernels)
            or not any("identity_tail" in k for k in kernels)):
        raise AssertionError(f"one K13 call launched {prof['per_call']}, not one memset, "
                             f"run_aggregate_kernel and identity_tail")
    log(f"[timing] {card}: run_aggregate (uniform), device ms a call by launch (one memset and "
        f"K13's two kernels, nothing else): {device_parts(prof, top=6)}")
    main = shapes["uniform"]
    rec.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    rec["shape"] = (f"{main['rows']} sorted rows (16,777,200-row uniform table, field 1, after "
                    f"the filter), num as the one measure")
    rec["shapes"] = shapes
    rec["by_launch"] = {launch_name(k): us / 1e3 for k, us in prof["top"]}
    return rec


def k14_record(captured: dict, runs: dict, errs: dict, card: str) -> dict:
    from database_technology_algorithms_tpu_torch.kernels.expand_sources import (
        expand_sources, expand_sources_plain)

    def timing(c, total, cap):
        nprobe = c.shape[0]
        mult = torch.diff(c, prepend=c.new_zeros(1)).long()
        rows = torch.arange(nprobe, device=c.device)
        nbytes = 4 * nprobe + 4 * cap  # c in, src out (the kernel reads no total)
        # the merge: one compare an item of cap + nprobe
        bound, by = bound_of(nbytes, cap + nprobe)
        return {"ms": device_ms(lambda: expand_sources(c, total, cap)),
                "plain_ms": device_ms(lambda: expand_sources_plain(c, total, cap)),
                "library_ms": device_ms(
                    lambda: torch.repeat_interleave(rows, mult, output_size=cap)),
                "bound_ms": bound, "bound_by": by, "nbytes": nbytes,
                "shape": f"{nprobe} probe rows -> {cap} output rows"}

    c, total, cap = captured["field 3"]
    alone = profile_device(lambda: expand_sources(c, total, cap), reps=10)
    if len(alone["per_call"]) != 1 or "expand_sources_kernel" not in alone["per_call"][0]:
        raise AssertionError(f"K14's wrapper launched {alone['per_call']}, not one kernel")
    rec = {"name": "expand_sources", "route": "cuda", "source": f"{PKG}/csrc/expand_sources.cu",
           "replaces": f"{JAX_PKG}/ops/hash_join.py:682",
           "launches": runs[("field 3", f"cap {cap}")]["launches"]["expand_sources"],
           "max_abs_err": errs["expand_sources"]}
    main = timing(c, total, cap)
    main["shape"] += " (cap = total, field 3)"
    heavy = torch.zeros(ROWS, dtype=torch.int32, device=c.device)
    heavy[ROWS // 3] = ROWS
    hc = torch.cumsum(heavy, 0, dtype=torch.int32)
    err = assert_same("K14 on a heavy row", (expand_sources(hc, hc[-1], ROWS),),
                      (expand_sources_plain(hc, hc[-1], ROWS),))
    rec["heavy_row"] = dict(timing(hc, hc[-1], ROWS), max_abs_err=err)
    rec["heavy_row"]["shape"] += " (one probe row holds every output)"
    for r in (main, rec["heavy_row"]):
        log(f"[timing] {card}: expand_sources ({r['shape']}): device time per call (one "
            f"launch): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"repeat_interleave {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['nbytes']} B, by {r['bound_by']})")
    rec.update({k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "shape")})
    return rec


# ---------------------------------------------------------------------------
# phase 10: the alternative u32 engines (K15-K18)

JOIN_ENGINES = ("searchsorted", "table", "bucketed")
JOIN_ENGINE_KERNELS = {
    "searchsorted": ("radix_sort", "sorted_probe"),
    "table": ("hash_set_build", "hash_set_probe"),
    "bucketed": ("hash_words", "radix_sort", "bucket_probe", "unpermute"),
}
FASTPATH_KERNELS = ("radix_sort", "compact", "take_fill")
EMPTY_PAIR = (0xDBDF60C1, 0x331DA083)  # their mixes: 0xFFFFFFFE, 0xFFFFFFFF (EMPTY)
CLUSTER_KEYS = 100  # keys sharing one home slot of the table: past 64 the build fails
ENGINE_FALLBACKS = (("hash_join", "build_key_multiset", "bucketed"),
                    ("hash_table", "hash_join_count_u32", "table"))


def inverse_mix(h) -> np.ndarray:
    """The u32 keys whose murmur3 finalizer (``ops/hash_table._mix``) is h."""
    h = np.asarray(h, dtype=np.uint64) & 0xFFFFFFFF
    h ^= h >> 16
    h = (h * 0x7ED1B41D) & 0xFFFFFFFF
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * 0xA5CB9243) & 0xFFFFFFFF
    h ^= h >> 16
    return h.astype(np.uint32)


def engine_cfg(engine: str):
    from database_technology_algorithms_tpu_torch.config import EngineConfig

    if engine == "fastpath":
        return EngineConfig(u32_distinct_engine="fastpath")
    return EngineConfig() if engine == "generic" else EngineConfig(u32_join_engine=engine)


@contextlib.contextmanager
def fallback_calls():
    """Count the engines' fallbacks taken inside: the bucketed engine's
    ``build_key_multiset`` and the table's ``hash_join_count_u32``, by
    engine.  The wrapped functions still run."""
    counts = {engine: 0 for _, _, engine in ENGINE_FALLBACKS}
    saved = []
    for module_name, name, engine in ENGINE_FALLBACKS:
        module = importlib.import_module(f"{PKG}.ops.{module_name}")
        fn = getattr(module, name)

        def record(*a, _fn=fn, _engine=engine, **kw):
            counts[_engine] += 1
            return _fn(*a, **kw)

        setattr(module, name, record)
        saved.append((module, name, fn))
    try:
        yield counts
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def membership_oracle(bkeys: np.ndarray, nb_live: int, pkeys: np.ndarray,
                      np_live: int) -> np.ndarray:
    """numpy: a probe row matches where it is live and its key is among the
    live build keys."""
    want = np.isin(pkeys, bkeys[:nb_live])
    want[np_live:] = False
    return want


def check_count(res, want: np.ndarray, what: str, generic=None) -> None:
    matched, mult, nres = res
    if not np.array_equal(matched.cpu().numpy(), want):
        raise AssertionError(f"{what}: matched differs from numpy")
    if not torch.equal(mult, matched.to(torch.int32)) or int(nres) != int(want.sum()):
        raise AssertionError(f"{what}: mult or nres differ from numpy")
    if generic is not None and not all(torch.equal(a, b) for a, b in zip(res, generic)):
        raise AssertionError(f"{what}: differs from the generic engine")


def engine_runs(tag: str, build, probe, field: int, bc, pc, want: np.ndarray, card: str,
                timed_runs: bool, runs: dict) -> None:
    """hash_join_count under the generic engine and each alternative one:
    launches counted from 0 around each run, each result against numpy and
    the generic engine's, no fallback taken; with `timed_runs`, each
    engine's host wall and device time and ``torch.isin`` of the live keys
    beside them."""
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count

    generic = None
    line = []
    for engine in ("generic",) + JOIN_ENGINES:
        cfg = engine_cfg(engine)
        fn = lambda: hash_join_count(build, probe, field, cfg, build_count=bc, probe_count=pc)
        with fallback_calls() as fell:
            torch.cuda.synchronize()
            reset_launches()
            res = fn()
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
        if any(fell.values()):
            raise AssertionError(f"[engines] {engine} {tag}: took a fallback {fell}")
        check_count(res, want, f"[engines] {engine} {tag}", generic)
        if engine == "generic":
            generic = res
        else:
            check_launched(launches, JOIN_ENGINE_KERNELS[engine], f"{engine} {tag}")
        rec = {"launches": {k: v for k, v in launches.items() if v}, "fallbacks": 0}
        if timed_runs:
            rec["wall_ms"] = wall_ms(fn, reps=5)
            prof = profile_device(fn, reps=3)
            rec["device_ms"] = prof["busy_us"] / 1e3
            rec["parts"] = device_parts(prof, top=3)
            line.append(f"{engine} {rec['device_ms']:.4f} / {rec['wall_ms']:.4f}")
        runs[(tag, engine)] = rec
    if timed_runs:
        nb_live = build.nrows if bc is None else int(bc)
        np_live = probe.nrows if pc is None else int(pc)
        bk = (build.recid if field == 0 else build.num)[:nb_live]
        pk = (probe.recid if field == 0 else probe.num)[:np_live]
        isin = lambda: torch.isin(pk, bk)
        if not np.array_equal(isin().cpu().numpy(), want[:np_live]):
            raise AssertionError(f"[engines] torch.isin {tag}: differs from numpy")
        runs[(tag, "torch.isin")] = {"wall_ms": wall_ms(isin, reps=5), "device_ms": device_ms(isin)}
        line.append(f"torch.isin {runs[(tag, 'torch.isin')]['device_ms']:.4f} / "
                    f"{runs[(tag, 'torch.isin')]['wall_ms']:.4f}")
    log(f"[engines] {card}: hash_join_count {tag}: {int(want.sum())} matches, every engine == "
        f"numpy and the generic engine, no fallback"
        + (("; device / host wall ms (median of 5 synchronized runs): " + ", ".join(line))
           if timed_runs else ""))
    for engine in JOIN_ENGINES:
        log(f"[engines]   {engine}: launches {runs[(tag, engine)]['launches']}"
            + (f"; largest kernels, ms: {runs[(tag, engine)]['parts']}" if timed_runs else ""))


def k15_edges(g, dev) -> list:
    """(what, args) of K15 at its edges: an empty build, a count of 0,
    keys with bit 31 set, a live 0xFFFFFFFF, sizes of 16 * 2^k +- 1, the
    counts on the host and on the card; and build columns past one index's
    reach (2^20 + 1 and 8,388,609 rows) with counts on the card at S * E +- 1,
    E the index tree's keys and S its stride (``engines_plan.probe_plan``)."""
    from database_technology_algorithms_tpu_torch.kernels import engines_plan

    def on_card(c):
        return torch.tensor(c, dtype=torch.int32, device=dev)

    def case(keys, n_live, probes):
        nb = len(keys)
        skey = np.concatenate([np.sort(keys[:n_live]),
                               np.full(nb - n_live, 0xFFFFFFFF, np.uint32)])
        if n_live:
            skey[n_live - 1] = 0xFFFFFFFF  # a live U32_MAX at count - 1
        probe = np.concatenate([g.choice(np.append(keys, 0xFFFFFFFF), probes) if nb else
                                np.full(probes, 0xFFFFFFFF),
                                g.integers(0, 2**32, probes + 1, dtype=np.uint64)]).astype(
            np.uint32)
        return u32_dev(skey, dev), u32_dev(probe, dev)

    cases = []
    for nb in (0, 1, 15, 17, 1023, 1025, 65535, 65537):
        keys = g.integers(0, 2**32, size=nb, dtype=np.uint64).astype(np.uint32)
        keys[::3] = keys[::3] % 512 | np.uint32(1 << 31)
        for live, where in ((nb, "host"), (nb // 2, "card"), (0, "host"), (None, "none")):
            skey, probe = case(keys, nb if live is None else live, 2048)
            bc = live if where != "card" else on_card(live)
            for pc in (None, 4000, on_card(3001)):
                cases.append((f"nb={nb} count={live} ({where}) probe_count="
                              f"{pc if not isinstance(pc, torch.Tensor) else int(pc)}",
                              (skey, bc, probe, pc)))
    for nb in ((1 << 20) + 1, 8_388_609):
        keys = g.integers(0, 2**32, size=nb, dtype=np.uint64).astype(np.uint32)
        keys[::3] = keys[::3] % 512 | np.uint32(1 << 31)
        E = (1 << engines_plan.probe_plan(nb).levels) - 1
        S = nb // E
        for live, where in ((S * E - 1, "card"), (S * E + 1, "card"), (nb, "host")):
            skey, probe = case(keys, live, 1 << 15)
            bc = live if where == "host" else on_card(live)
            stride, entries = engines_plan.probe_stride(live, engines_plan.probe_plan(nb).levels)
            for pc in (None, on_card(3001)):
                cases.append((f"nb={nb} count={live} ({where}; S={stride}, {entries} index "
                              f"keys) probe_count="
                              f"{pc if not isinstance(pc, torch.Tensor) else int(pc)}",
                              (skey, bc, probe, pc)))
    return cases


def u32_dev(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(dev)


def hash_set_parts(hs) -> list:
    """What of K16's result the order of its atomics leaves fixed: the
    stored values sorted (where keys failed, how many slots hold one), the
    EMPTY-key flag and the failure count."""
    stored = hs.slots[hs.slots != -1]
    body = (torch.sort(stored).values if int(hs.n_failed) == 0 else
            torch.tensor([stored.numel()], device=stored.device))
    return [body, hs.has_empty_key.reshape(1), hs.n_failed.reshape(1)]


def k16_edges(g, dev) -> list:
    """(what, keys, size, count, limit) of K16 and K17 at their edges: n % 4
    of 0-3 (the vector path's tail), a view one word in (the scalar path),
    duplicates, the EMPTY pair, keys on one home slot (failing at limit 8,
    also 20 keys of 5 copies each), 1M keys all equal."""
    from database_technology_algorithms_tpu_torch.ops.hash_table import table_size_for

    cases = []
    for n, kind in ((0, "empty"), (1, "random"), (17, "random"), (1025, "random"),
                    (65536, "random"), (65537, "random"), (65538, "random"),
                    (65539, "random"), (65537, "duplicates"), (65541, "one word in"),
                    (4097, "empty pair"), (CLUSTER_KEYS, "one home slot"),
                    (CLUSTER_KEYS, "one home slot, 5 copies"), (5000, "bit 31"),
                    (ROWS, "all equal")):
        size = table_size_for(n)
        keys = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        if kind == "duplicates":
            keys = g.choice(keys[:500], size=n)
        elif kind == "empty pair":
            keys[::100], keys[1::100] = EMPTY_PAIR
        elif kind == "one home slot":
            keys = inverse_mix(11 + size * np.arange(n, dtype=np.uint64))
        elif kind == "one home slot, 5 copies":  # 20 apart: a live prefix of 60 holds 3 each
            keys = np.tile(inverse_mix(11 + size * np.arange(n // 5, dtype=np.uint64)), 5)
        elif kind == "bit 31":
            keys |= np.uint32(1 << 31)
        elif kind == "all equal":
            keys[:] = 77
        t = u32_dev(keys, dev)
        if kind == "one word in":
            t = t[1:]
            n, size = n - 1, table_size_for(n - 1)
        # a limit below 64 only where no other key is near: elsewhere which
        # keys fail would hang on the atomics' order
        short = 8 if kind.startswith("one home slot") else 64
        # which keys fail hangs on the order too, so every key has as many live copies
        live = 3 * n // 5 if kind.endswith("copies") else n - n // 3
        on_card = torch.tensor(live, dtype=torch.int32, device=dev)
        for count, limit in ((None, 64), (n // 2, 64), (on_card, short)):
            shown = int(count) if isinstance(count, torch.Tensor) else count
            cases.append((f"n={n} {kind} count={shown} limit={limit}", t, size, count, limit))
    return cases


def probe_total(hs, keys, count=None, max_probe: int = 64) -> list:
    """K17 with its fused total: [found, mult, total]."""
    from database_technology_algorithms_tpu_torch.kernels.hash_set import hash_set_probe

    total = torch.full((), -1, dtype=torch.int32, device=keys.device)
    found, mult = hash_set_probe(hs, keys, count, max_probe, total=total)
    return [found, mult, total.reshape(1)]


def probe_total_plain(hs, keys, count=None, max_probe: int = 64) -> list:
    """The plain version's found and mult, and the sum of mult."""
    from database_technology_algorithms_tpu_torch.kernels.hash_set import hash_set_probe_plain

    found, mult = hash_set_probe_plain(hs, keys, count, max_probe)
    return [found, mult, mult.sum(dtype=torch.int32).reshape(1)]


# K17 under the window and hints its plan gives other tables: 1-slot
# windows (a table under 4 slots) and the evict-first hints on (a table
# past SET_PROBE_STREAM_BYTES) and off, each at either window
K17_PLANS = (dict(SET_PROBE_WINDOW=1, SET_PROBE_STREAM_BYTES=1 << 40),
             dict(SET_PROBE_WINDOW=1, SET_PROBE_STREAM_BYTES=0),
             dict(SET_PROBE_STREAM_BYTES=0), dict(SET_PROBE_STREAM_BYTES=1 << 40))


def engines_plan_set(**values):
    """``kernels/engines_plan``'s constants set to `values` for a block's
    calls (``tools/hash_sweep.plan``)."""
    from database_technology_algorithms_tpu_torch.kernels import engines_plan
    from database_technology_algorithms_tpu_torch.tools.hash_sweep import plan

    return plan(engines_plan, **values)


def k17_wide_tables(g, dev) -> int:
    """K17 against its plain version on tables of 2^24 and 2^25 slots (64
    and 128 MB) built from 8,388,608 random keys, probed by 8,388,608 keys
    of which half are built, with a live count, max_probe 64 and 1, and
    under the other plans of ``K17_PLANS``."""
    from database_technology_algorithms_tpu_torch.kernels.hash_set import hash_set_build

    n = BIG_ROWS
    keys = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    probe = np.where(g.random(n) < 0.5, g.permutation(keys),
                     g.integers(0, 2**32, size=n, dtype=np.uint64)).astype(np.uint32)
    kt, pt = u32_dev(keys, dev), u32_dev(probe, dev)
    worst = 0
    for size in (1 << 24, 1 << 25):
        hs = hash_set_build(kt, size)
        for pc, max_probe in ((None, 64), (n - 12345, 64), (None, 1)):
            want = probe_total_plain(hs, pt, pc, max_probe)
            worst = max(worst, assert_same(f"K17 {n} keys against {size} slots, "
                                           f"count {pc}, max_probe {max_probe}",
                                           probe_total(hs, pt, pc, max_probe), want))
            if max_probe != 64:
                continue
            for values in K17_PLANS:
                with engines_plan_set(**values):
                    worst = max(worst, assert_same(
                        f"K17 {n} keys against {size} slots, count {pc}, {values}",
                        probe_total(hs, pt, pc, max_probe), want))
        del hs, want
    torch.cuda.synchronize()
    log(f"[kernels] K17 equals its plain version on tables of 2^24 and 2^25 slots ({n} random "
        f"keys, {n} probes half built; the live count, max_probe 64 and 1, the plan and "
        f"{len(K17_PLANS)} others), total == sum of mult")
    return worst


def k18_edges(g, dev) -> list:
    """(what, args) of K18 at its edges: overflow on either side, an
    inactive tail, empty sides, one bucket, keys with bit 31 set, a sparse
    case (65,536 buckets, 1,000 + 1,000 rows) and a side all inactive."""
    cases = []
    for nbuckets, nb, npr, kind, cap in ((1, 100, 100, "one bucket", 128),
                                         (16, 300, 400, "build overflow", 4),
                                         (16, 300, 400, "probe overflow", 4),
                                         (16, 0, 400, "empty build", 128),
                                         (16, 300, 0, "empty probe", 128),
                                         (4096, 70_000, 65_000, "inactive tail", 128),
                                         (65536, 1 << 20, 1 << 20, "uniform", 128),
                                         (65536, 1 << 20, 1 << 20, "heavy buckets", 128),
                                         (65536, 1000, 1000, "sparse", 128),
                                         (65536, 1 << 20, 1 << 20, "build inactive", 128),
                                         (65536, 1 << 20, 1 << 20, "probe inactive", 128)):
        sides = []
        for n, heavy, inactive in ((nb, kind in ("build overflow", "heavy buckets"),
                                    kind == "build inactive"),
                                   (npr, kind in ("probe overflow", "heavy buckets"),
                                    kind == "probe inactive")):
            b = g.integers(0, nbuckets, size=n)
            if heavy and n:
                b[: 3 * cap] = g.integers(0, 3, size=3 * cap)
            if kind == "inactive tail":
                b[n - n // 4:] = nbuckets
            if kind == "sparse":  # most buckets empty, the first live one above 0
                b = g.integers(1000, nbuckets, size=n)
            if inactive:
                b[:] = nbuckets
            keys = (g.integers(0, 64, size=n) | np.where(g.random(n) < 0.5, 1 << 31, 0)).astype(
                np.uint32)
            sides += [torch.from_numpy(np.sort(b).astype(np.int32)).to(dev), u32_dev(keys, dev)]
        cases.append((f"{kind}: {nbuckets} buckets, {nb} + {npr} rows, cap {cap}",
                      (*sides, nbuckets, cap)))
    return cases


def check_engine_kernels_at_edges(g, dev) -> dict:
    from database_technology_algorithms_tpu_torch.kernels import engines_plan
    from database_technology_algorithms_tpu_torch.kernels.bucket_probe import (
        bucket_probe, bucket_probe_plain)
    from database_technology_algorithms_tpu_torch.kernels.hash_set import (
        hash_set_build, hash_set_build_plain)
    from database_technology_algorithms_tpu_torch.kernels.sorted_probe import (
        sorted_probe, sorted_probe_plain)

    errs = {"sorted_probe": 0, "hash_set_build": 0, "hash_set_probe": 0, "bucket_probe": 0}
    for what, args in k15_edges(g, dev):
        errs["sorted_probe"] = max(errs["sorted_probe"], assert_same(
            f"K15 {what}", sorted_probe(*args), sorted_probe_plain(*args)))
    for what, keys, size, count, limit in k16_edges(g, dev):
        hs = hash_set_build(keys, size, count, limit)
        errs["hash_set_build"] = max(errs["hash_set_build"], assert_same(
            f"K16 {what}", hash_set_parts(hs),
            hash_set_parts(hash_set_build_plain(keys, size, count, limit))))
        if what.split()[1] in ("random", "one"):  # 4 keys a thread: the tail, the scalar path
            saved, engines_plan.HASH_KEYS = engines_plan.HASH_KEYS, 4
            try:
                assert_same(f"K16 {what}, 4 keys a thread", hash_set_parts(
                    hash_set_build(keys, size, count, limit)), hash_set_parts(
                    hash_set_build_plain(keys, size, count, limit)))
            finally:
                engines_plan.HASH_KEYS = saved
        probe = torch.cat([keys, u32_dev(np.array(EMPTY_PAIR + (7,), np.uint32), dev)])
        for pc, max_probe in ((None, limit), (probe.shape[0] - 2, 200), (None, 1), (None, 0),
                              (0, 64)):
            want = probe_total_plain(hs, probe, pc, max_probe)
            errs["hash_set_probe"] = max(errs["hash_set_probe"], assert_same(
                f"K17 {what} probe_count={pc} max_probe={max_probe}",
                probe_total(hs, probe, pc, max_probe), want))
            for values in K17_PLANS:  # the other windows and hints
                with engines_plan_set(**values):
                    errs["hash_set_probe"] = max(errs["hash_set_probe"], assert_same(
                        f"K17 {what} probe_count={pc} max_probe={max_probe}, {values}",
                        probe_total(hs, probe, pc, max_probe), want))
    for what, args in k18_edges(g, dev):
        errs["bucket_probe"] = max(errs["bucket_probe"], assert_same(
            f"K18 {what}", bucket_probe(*args), bucket_probe_plain(*args)))
    errs["hash_set_probe"] = max(errs["hash_set_probe"], k17_wide_tables(g, dev))
    torch.cuda.synchronize()
    log("[kernels] K15-K18 equal their plain versions at their edges (K15: empty build, count "
        "0, bit 31, a live 0xFFFFFFFF, 16*2^k +- 1 rows, counts on the host and the card, "
        "2^20 + 1 and 8,388,609 rows with counts on the card at S*E +- 1; K16: "
        "the stored set, flag and failures, with duplicates, the EMPTY pair, 100 keys on one "
        "home slot (and 20 of 5 copies each), limits 64 and 8, n % 4 of 0-3, a view one word "
        "in, 1M keys all equal, the random keys and the view also at 4 keys a thread; K17 on "
        "K16's tables, max_probe 0, 1, the limit and 200, a count of 0, under its plan and "
        "1- and 4-slot windows with the evict-first hints on and off, its fused "
        "total == the sum of mult; 2^24- and 2^25-slot tables; "
        "K18: overflow on either side, inactive tails, empty sides, 1-65536 buckets, a sparse "
        "case, a side all inactive)")
    return errs


def phase_engines(dev, card: str) -> dict:
    """The alternative u32 engines at the bench's shape: hash_join_count and
    hash_join under "searchsorted", "table" and "bucketed" at fields 0 and 1
    on 1M + 1M rows (raw tables, and the dedup'd sides with live counts),
    field 1 at 8M + 8M (and ``hash_join`` under "table" there);
    ``distinct`` and ``merge_join`` under "fastpath" at
    1M and 16M rows; each against numpy and the generic engine, with the
    launch counters set to 0 around each run, times beside the generic
    engine's and ``torch.isin``; the three forced fallbacks; K15-K18 against
    their plain versions at their edges and on the 1M runs' own inputs."""
    from database_technology_algorithms_tpu_torch.batch import RecordBatch
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join, hash_join_count
    from database_technology_algorithms_tpu_torch.ops.hash_table import table_size_for
    from database_technology_algorithms_tpu_torch.ops.merge_join import merge_join
    # the engines' modules bind the kernels' wrappers when first imported:
    # import them before any recorder swaps a wrapper
    from database_technology_algorithms_tpu_torch.ops import bucket_join, fastpath  # noqa: F401

    t_phase = time.time()
    g = np.random.default_rng(13)
    errs = check_engine_kernels_at_edges(g, dev)
    runs: dict = {}
    captured = {}
    # ---- 1M + 1M: fields 0 and 1, raw and dedup'd -----------------------------------
    r_cols, s_cols = gen_pair(ROWS)
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    for field in (1, 0):
        name = "recid" if field == 0 else "num"
        rk, sk = r_cols[name], s_cols[name]
        tag = f"field {field}, {ROWS} + {ROWS} rows"
        recorders = [("sorted_probe", "sorted_probe"), ("hash_set", "hash_set_build"),
                     ("hash_set", "hash_set_probe"), ("bucket_probe", "bucket_probe")]
        with contextlib.ExitStack() as stack:
            calls = {n: stack.enter_context(recorded_calls(m, n)) for m, n in recorders}
            engine_runs(tag, s, r, field, None, None, membership_oracle(sk, ROWS, rk, ROWS),
                        card, True, runs)
        if field == 1:
            captured = {n: c[0][0] for n, c in calls.items()}
        r_d, nu_r = distinct(r, field)
        s_d, nu_s = distinct(s, field)
        ur, us = np.unique(rk), np.unique(sk)
        if (int(nu_r), int(nu_s)) != (len(ur), len(us)):
            raise AssertionError(f"[engines] distinct {tag}: counts differ from numpy")
        want = membership_oracle(np.pad(us, (0, ROWS - len(us))), len(us),
                                 np.pad(ur, (0, ROWS - len(ur))), len(ur))
        engine_runs(f"{tag}, dedup'd ({len(us)} + {len(ur)} live)", s_d, r_d, field, nu_s, nu_r,
                    want, card, field == 1, runs)
        hit = np.isin(rk, sk)
        g_out, g_n = hash_join(s, r, field)
        for engine in JOIN_ENGINES:
            out, n_out = hash_join(s, r, field, engine_cfg(engine))
            if int(n_out) != int(hit.sum()) or not np.array_equal(
                    u32_host(out.recid[: int(hit.sum())]), r_cols["recid"][hit]):
                raise AssertionError(f"[engines] hash_join {engine} {tag}: rows differ from numpy")
            for c in ("recid", "num", "strw", "valid"):
                if not torch.equal(getattr(out, c), getattr(g_out, c)):
                    raise AssertionError(f"[engines] hash_join {engine} {tag}: {c} differs "
                                         f"from the generic engine")
        log(f"[engines] hash_join {tag}: {int(hit.sum())} probe rows emitted under every "
            f"engine, == numpy and the generic engine's batch")
        del r_d, s_d, g_out, out
    # ---- distinct and merge_join under "fastpath", 1M --------------------------------
    fast = engine_cfg("fastpath")

    def fastpath_runs(tag: str, batch, r2, s2, want_n: int, want_pairs: int) -> None:
        for op, fn, gen in (
                ("distinct", lambda: distinct(batch, 1, fast), lambda: distinct(batch, 1)),
                ("merge_join", lambda: merge_join(r2, s2, 1, fast), lambda: merge_join(r2, s2, 1))):
            torch.cuda.synchronize()
            reset_launches()
            got = fn()
            torch.cuda.synchronize()
            check_launched(dict(LAUNCHES), FASTPATH_KERNELS, f"{op} fastpath {tag}")
            want = gen()
            if int(got[1]) != (want_n if op == "distinct" else want_pairs):
                raise AssertionError(f"[engines] {op} fastpath {tag}: count differs from numpy")
            for c in ("recid", "num", "strw", "valid"):
                if not torch.equal(getattr(got[0], c), getattr(want[0], c)):
                    raise AssertionError(f"[engines] {op} fastpath {tag}: {c} differs from the "
                                         f"generic engine")
            times = {}
            for engine, f in (("fastpath", fn), ("generic", gen)):
                times[engine] = (device_ms(f), wall_ms(f, reps=3))
                runs[(f"{op} {tag}", engine)] = {"device_ms": times[engine][0],
                                                 "wall_ms": times[engine][1]}
            log(f"[engines] {card}: {op} fastpath {tag}: {int(got[1])} == numpy, equal to the "
                f"generic engine; device / host wall ms: fastpath {times['fastpath'][0]:.4f} / "
                f"{times['fastpath'][1]:.4f}, generic {times['generic'][0]:.4f} / "
                f"{times['generic'][1]:.4f}")

    pairs = len(np.intersect1d(r_cols["num"], s_cols["num"]))
    fastpath_runs(f"field 1, {ROWS} rows (merge_join {ROWS} + {ROWS})", r, r, s,
                  len(np.unique(r_cols["num"])), pairs)
    # ---- the forced fallbacks, 1M + 1M, field 1 --------------------------------------
    rk, sk = r_cols["num"], s_cols["num"]
    size = table_size_for(ROWS)
    cluster = inverse_mix(5 + size * np.arange(CLUSTER_KEYS, dtype=np.uint64))
    forced = []
    b_eq = dict(s_cols, num=np.full(ROWS, 77, np.uint32))
    forced.append(("bucketed", "all build keys equal", b_eq, r_cols))
    b_cl = dict(s_cols, num=np.concatenate([cluster, sk[CLUSTER_KEYS:]]))
    p_cl = dict(r_cols, num=np.concatenate([cluster[::2], rk[CLUSTER_KEYS // 2:]]))
    forced.append(("table", f"{CLUSTER_KEYS} build keys on one home slot", b_cl, p_cl))
    for engine, what, bc_cols, pc_cols in forced:
        build, probe = to_batch(bc_cols, dev), to_batch(pc_cols, dev)
        want = membership_oracle(bc_cols["num"], ROWS, pc_cols["num"], ROWS)
        with fallback_calls() as fell:
            res = hash_join_count(build, probe, 1, engine_cfg(engine))
        check_count(res, want, f"[engines] {engine} {what}", hash_join_count(build, probe, 1))
        if fell[engine] != 1:
            raise AssertionError(f"[engines] {engine} {what}: the fallback ran {fell} times")
        runs[(f"forced: {what}", engine)] = {"fallbacks": fell[engine]}
        log(f"[engines] forced fallback, {engine}, {what}: the fallback ran ({fell}); "
            f"{int(want.sum())} matches == numpy and the generic engine")
    # the EMPTY pair: the key whose mix is EMPTY is flagged, never stored as its pair's mix
    for held in EMPTY_PAIR:
        b_e = dict(s_cols, num=np.concatenate([[held], sk[1:]]).astype(np.uint32))
        p_e = dict(r_cols, num=np.concatenate([list(EMPTY_PAIR), rk[2:]]).astype(np.uint32))
        build, probe = to_batch(b_e, dev), to_batch(p_e, dev)
        want = membership_oracle(b_e["num"], ROWS, p_e["num"], ROWS)
        with fallback_calls() as fell:
            res = hash_join_count(build, probe, 1, engine_cfg("table"))
        check_count(res, want, f"[engines] table, the EMPTY pair, build holds {held:#x}",
                    hash_join_count(build, probe, 1))
        if any(fell.values()):
            raise AssertionError(f"[engines] table EMPTY pair: a fallback ran {fell}")
        log(f"[engines] the EMPTY pair: a build holding only {held:#x} matches the probe's "
            f"{held:#x} and not its pair: {res[0][:2].tolist()} == numpy and the generic engine")
    del build, probe, res
    # ---- K15-K18 on the 1M field-1 run's own inputs ----------------------------------
    own = check_engine_kernels_on(captured, f"{ROWS} field-1")
    for k, e in own.items():
        errs[k] = max(errs[k], e)
    # ---- 8M + 8M, field 1, the budget's edge -----------------------------------------
    del r, s
    r_cols, s_cols = gen_pair(BIG_ROWS)
    r, s = to_batch(r_cols, dev), to_batch(s_cols, dev)
    with contextlib.ExitStack() as stack:
        calls = {n: stack.enter_context(recorded_calls(m, n)) for m, n in BIG_RECORDED}
        engine_runs(f"field 1, {BIG_ROWS} + {BIG_ROWS} rows", s, r, 1, None, None,
                    membership_oracle(s_cols["num"], BIG_ROWS, r_cols["num"], BIG_ROWS), card,
                    True, runs)
    captured_big = {n: c[0][0] for n, c in calls.items()}
    for name, e in check_engine_kernels_on(captured_big, f"{BIG_ROWS} field-1").items():
        errs[name] = max(errs[name], e)
    hit = np.isin(r_cols["num"], s_cols["num"])
    out, n_out = hash_join(s, r, 1, engine_cfg("table"))
    if int(n_out) != int(hit.sum()) or not np.array_equal(
            u32_host(out.recid[: int(hit.sum())]), r_cols["recid"][hit]):
        raise AssertionError(f"[engines] hash_join table, {BIG_ROWS} + {BIG_ROWS}: rows differ "
                             f"from numpy")
    log(f"[engines] hash_join table, field 1, {BIG_ROWS} + {BIG_ROWS} rows: {int(hit.sum())} "
        f"probe rows emitted, == numpy")
    del out, hit
    both = RecordBatch.concat([r, s])
    fastpath_runs(f"field 1, {2 * BIG_ROWS} rows (merge_join {BIG_ROWS} + {BIG_ROWS})", both,
                  r, s, len(np.unique(np.concatenate([r_cols["num"], s_cols["num"]]))),
                  len(np.intersect1d(r_cols["num"], s_cols["num"])))
    del both, r, s
    recs = engine_records(captured, captured_big, runs, errs, card)
    log(f"[engines] the phase took {time.time() - t_phase:.1f} s")
    return {"recs": recs, "runs": runs}


def check_engine_kernels_on(captured: dict, run: str) -> dict:
    """The kernels in `captured` (of K15-K18) against their plain versions
    on the arguments the `run` runs gave them (K16 by the parts its atomics'
    order leaves fixed; K17 on the kernel's own table, with its total)."""
    from database_technology_algorithms_tpu_torch.kernels.bucket_probe import (
        bucket_probe, bucket_probe_plain)
    from database_technology_algorithms_tpu_torch.kernels.hash_set import (
        hash_set_build, hash_set_build_plain)
    from database_technology_algorithms_tpu_torch.kernels.sorted_probe import (
        sorted_probe, sorted_probe_plain)

    pairs = {"sorted_probe": (lambda a: sorted_probe(*a), lambda a: sorted_probe_plain(*a)),
             "hash_set_build": (lambda a: hash_set_parts(hash_set_build(*a)),
                                lambda a: hash_set_parts(hash_set_build_plain(*a))),
             "hash_set_probe": (lambda a: probe_total(*a), lambda a: probe_total_plain(*a)),
             "bucket_probe": (lambda a: bucket_probe(*a), lambda a: bucket_probe_plain(*a))}
    errs = {k: assert_same(f"{k} on the {run} run's inputs", kern(captured[k]),
                           plain(captured[k]))
            for k, (kern, plain) in pairs.items() if k in captured}
    torch.cuda.synchronize()
    log(f"[kernels] {', '.join(errs)} equal their plain versions on the {run} runs' own inputs; "
        f"max abs err {errs}")
    return errs


# K15-K18 at 8M + 8M as well
BIG_RECORDED = (("sorted_probe", "sorted_probe"), ("bucket_probe", "bucket_probe"),
                ("hash_set", "hash_set_build"), ("hash_set", "hash_set_probe"))


def probe_specs(captured: dict) -> dict:
    """K15-K18's calls of one run: their wrappers, plain versions, PyTorch
    yardstick, bytes and operations, shape (K16 by the parts of its result
    that the order of its atomics leaves fixed)."""
    from database_technology_algorithms_tpu_torch.batch import as_u32
    from database_technology_algorithms_tpu_torch.kernels.bucket_probe import (
        bucket_probe, bucket_probe_plain)
    from database_technology_algorithms_tpu_torch.kernels.hash_set import (
        hash_set_build, hash_set_build_plain, hash_set_probe, hash_set_probe_plain)
    from database_technology_algorithms_tpu_torch.kernels.sorted_probe import (
        sorted_probe, sorted_probe_plain)

    args = captured["sorted_probe"]
    skey, pkey = args[0], args[2]
    nb, npr = skey.shape[0], pkey.shape[0]
    s64, p64 = as_u32(skey), as_u32(pkey)
    out = {"sorted_probe": dict(
        kern=lambda: sorted_probe(*args), plain=lambda: sorted_probe_plain(*args),
        lib=lambda: torch.searchsorted(s64, p64), lib_name="torch.searchsorted of the u32 values",
        nbytes=4 * nb + 4 * npr + 5 * npr,  # build and probe keys in; hit and mult out
        nops=npr * max(nb, 1).bit_length(), shape=f"{nb} sorted build keys, {npr} probe keys")}
    bargs = captured["bucket_probe"]
    bb, pb, nbuckets, cap = bargs[0], bargs[2], bargs[4], bargs[5]
    cb = torch.bincount(bb.long(), minlength=nbuckets + 1)[:nbuckets]
    cp = torch.bincount(pb.long(), minlength=nbuckets + 1)[:nbuckets]
    ok = (cb <= cap) & (cp <= cap)
    compares = int((cb * cp * ok).sum())
    searches = 4 * (nbuckets + 1) * max(bb.shape[0], pb.shape[0], 1).bit_length()
    bkeys_b, bkeys_p = bargs[1], bargs[3]
    out["bucket_probe"] = dict(
        kern=lambda: bucket_probe(*bargs), plain=lambda: bucket_probe_plain(*bargs),
        lib=lambda: torch.isin(bkeys_p, bkeys_b),
        lib_name="torch.isin of the probe keys in the build keys",
        nbytes=8 * bb.shape[0] + 9 * pb.shape[0] + 4, nops=compares + searches,
        shape=f"{nbuckets} buckets of cap {cap}, {bb.shape[0]} + {pb.shape[0]} rows, "
              f"{compares} key compares")
    keys, size, count, limit = captured["hash_set_build"]
    n = keys.shape[0]
    out["hash_set_build"] = dict(
        kern=lambda: hash_set_build(keys, size, count, limit),
        plain=lambda: hash_set_build_plain(keys, size, count, limit), lib=None, lib_name=None,
        nbytes=4 * n + 4 * size + 8, nops=12 * n, shape=f"{n} build keys into {size} slots")
    hs, pkeys, pcount, max_probe = captured["hash_set_probe"]
    npk = pkeys.shape[0]
    live_b = keys if count is None else keys[:int(count)]
    live_p = pkeys if pcount is None else pkeys[:int(pcount)]
    out["hash_set_probe"] = dict(  # as hash_join_count_table calls it: the entry zeroes total
        kern=lambda: hash_set_probe(hs, pkeys, pcount, max_probe, total=torch.empty(
            (), dtype=torch.int32, device=pkeys.device)),
        plain=lambda: hash_set_probe_plain(hs, pkeys, pcount, max_probe),
        lib=lambda: torch.isin(live_p, live_b),
        lib_name="torch.isin of the live probe keys in the live build keys",
        nbytes=4 * size + 4 + 4 * npk + 5 * npk + 4, nops=12 * npk,  # table, keys in; outputs
        shape=f"{npk} probe keys against {size} slots")
    return out


def probe_readings(name: str, sp: dict, card: str, what: str) -> dict:
    """One K15-K18 shape: device ms of a wrapper call, of its plain
    version and yardstick, its bound, and its launches' own times (each
    kernel and memset of one call)."""
    bound, by = bound_of(sp["nbytes"], sp["nops"])
    r = {"ms": device_ms(sp["kern"]), "plain_ms": device_ms(sp["plain"]), "bound_ms": bound,
         "bound_by": by,
         "library_ms": device_ms(sp["lib"]) if sp["lib"] is not None else None,
         "shape": sp["shape"]}
    r["by_launch"] = launches_in_order(sp["kern"])
    log(f"[timing] {card}: {name} ({what}: {sp['shape']}): device time per call: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        + (f"{sp['lib_name']} {r['library_ms']:.4f} ms" if sp["lib"] is not None else "none")
        + f", bound {bound:.4f} ms ({sp['nbytes']} B, {sp['nops']} ops, by {by}); by launch: "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in r["by_launch"]))
    return r


def launches_in_order(fn, reps: int = 10) -> list:
    """[name, ms] of each launch of one call of fn in the order they ran (two
    memsets of one call stay apart), each a mean over the whole calls of a
    fenced trace (``_profile_calls``)."""
    for _ in range(PROFILE_ATTEMPTS):
        calls, lost = _profile_calls(fn, reps)
        if calls:
            return [[launch_name(calls[-1][i].name),
                     sum(c[i].device_time for c in calls) / len(calls) / 1e3]
                    for i in range(len(calls[0]))]
    raise RuntimeError(f"torch.profiler lost device events inside the work: {lost}")


def engine_records(captured: dict, captured_big: dict, runs: dict, errs: dict,
                   card: str) -> list[dict]:
    """The kernels line's entries of K15-K18, at the 1M field-1 run's shapes
    and at the 8M + 8M run's (``at_8m``), each with its launches' own times
    in the order they ran (K16's two memsets apart)."""

    tag = f"field 1, {ROWS} + {ROWS} rows"
    big_tag = f"field 1, {BIG_ROWS} + {BIG_ROWS} rows"
    specs, big = probe_specs(captured), probe_specs(captured_big)
    out = []
    for name, engine, src, repl in (
            ("sorted_probe", "searchsorted", "csrc/sorted_probe.cu", "ops/fastpath.py:101"),
            ("bucket_probe", "bucketed", "csrc/bucket_probe.cu", "ops/bucket_join.py:59"),
            ("hash_set_build", "table", "csrc/hash_set.cu", "ops/hash_table.py:50"),
            ("hash_set_probe", "table", "csrc/hash_set.cu", "ops/hash_table.py:108")):
        rec = {"name": name, "route": "cuda", "source": f"{PKG}/{src}",
               "replaces": f"{JAX_PKG}/{repl}",
               "launches": runs[(tag, engine)]["launches"].get(name, 0),
               "max_abs_err": errs[name]}
        rec.update(probe_readings(name, specs[name], card, tag))
        rec["at_8m"] = probe_readings(name, big[name], card, big_tag)
        rec["at_8m"]["launches"] = runs[(big_tag, engine)]["launches"].get(name, 0)
        out.append(rec)
    order = ("sorted_probe", "hash_set_build", "hash_set_probe", "bucket_probe")
    return sorted(out, key=lambda r: order.index(r["name"]))


# ---------------------------------------------------------------------------
# phase 11: the distributed plan on a shard mesh (K19-K22, K9's fill)

DIST_SHARDS = 4  # on the one card: the in-process mesh of --dist 4
DIST_ROWS = 4 * ROWS  # a table: 1M rows a shard, the single-chip bench's size
DIST_BIG_ROWS = 16 * ROWS  # the timed run: 4M rows a shard
DIST_SMALL_ROWS = 3 * ROWS  # the 3-shard mesh: the unsigned modulo at ndev 3
DIST_NBLOCKS = 2000  # the CLI's files: 200K rows each
DIST_ENGINES = ("sorted", "skew", "overlap")
DIST_PHASE_LIMIT_S = 60.0
# what every run of the plan launches, and what each engine adds
DIST_KERNELS = ("stage_cells", "compact", "take_fill", "run_aggregate")
# K2 runs in the generic hash join of the sorted and skew engines (K13 finds
# its group ids itself)
DIST_ENGINE_KERNELS = {"sorted": ("seg_scan",), "skew": ("seg_scan", "words_sort", "topk_runs",
                                                         "hot_hashes", "in_hot_set"),
                       "overlap": ("words_sort",)}
DIST_RECORDED = (("topk_runs", "topk_runs"), ("hot_set", "hot_lists"), ("hot_set", "in_hot_set"),
                 ("range_dest", "range_dest"), ("stage_cells", "stage_to_cells"),
                 ("sorted_probe", "sorted_probe"))  # K15: the overlap engine's one-word probe


def dist_key_ids(cols: dict, field: int) -> np.ndarray:
    """Integer ids, equal exactly where the keys are, for dist_cols' keys:
    recid or num; a string of 5 lowercase letters (NUL-padded to 8 bytes)
    as its base-26 number; (num, string) as num * 26^5 + that number."""
    if field in (0, 1):
        return cols["recid" if field == 0 else "num"].astype(np.int64)
    strs = np.ascontiguousarray(cols["strs"])
    word = strs.view("<u8").reshape(-1).astype(np.int64)  # byte k in bits 8k..8k+7
    if strs.shape[1] != 8 or (word >> 40).any():
        raise AssertionError("dist oracle: the strings are not 5 bytes stored 8 wide")
    sid = np.zeros(len(strs), np.int64)
    for k in range(5):
        letter = ((word >> (8 * k)) & 0xFF) - 97
        if letter.size and (letter.min() < 0 or letter.max() > 25):
            raise AssertionError("dist oracle: the strings are not lowercase letters")
        sid = sid * 26 + letter
    return sid if field == 2 else cols["num"].astype(np.int64) * 26 ** 5 + sid


def dist_unique(ids: np.ndarray) -> np.ndarray:
    """The distinct ids, sorted: a presence table for small non-negative ids
    (one pass), np.unique otherwise."""
    if ids.size and ids.min() >= 0 and ids.max() < 1 << 26:
        present = np.zeros(int(ids.max()) + 1, bool)
        present[ids] = True
        return np.flatnonzero(present)
    return np.unique(ids)


def dist_oracle(r: dict, s: dict, field: int) -> dict:
    """numpy: the plan's counters over the valid rows, and the matched keys."""
    ur = dist_unique(dist_key_ids(r, field)[r["valid"]])
    us = dist_unique(dist_key_ids(s, field)[s["valid"]])
    both = ur[np.isin(ur, us, assume_unique=True)]
    return {"nunique_r": len(ur), "nunique_s": len(us), "merge_nres": len(both),
            "hash_nres": len(both), "agg_groups": len(us), "keys": both}


def dist_cols(rows: int, seed: int, zipf_a=None, recid_start: int = 0) -> dict:
    """A table of the generator's shape (``io/generator.generate_columns``:
    sequential recids, num uniform in the bench's key range 3 rows/10 or
    Zipf folded into it, 5 random lowercase letters; no planted "Hola"),
    drawn straight at an 8-byte string width, every seventh row invalid."""
    rng = np.random.default_rng(seed)
    key_range = max(3 * rows // 10, 1)
    num = (rng.zipf(zipf_a, rows) - 1) % key_range if zipf_a else rng.integers(0, key_range, rows)
    strs = np.zeros((rows, 8), np.uint8)
    strs[:, :5] = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)[
        rng.integers(0, 26, (rows, 5), dtype=np.uint8)]
    return {"recid": np.arange(recid_start, recid_start + rows, dtype=np.uint32),
            "num": num.astype(np.uint32), "strs": strs, "valid": np.arange(rows) % 7 != 3}


def dist_key_cols(batch, field: int) -> dict:
    """The host columns dist_key_ids reads of a port batch (only those)."""
    from database_technology_algorithms_tpu_torch.batch import unpack_str_words

    cols = {"recid": u32_host(batch.recid), "num": u32_host(batch.num)}
    if field in (2, 3):
        strs = unpack_str_words(u32_host(batch.strw).reshape(batch.nrows, batch.str_words))
        cols["strs"] = np.ascontiguousarray(strs[:, :8]) if strs.shape[1] >= 8 else np.pad(
            strs, ((0, 0), (0, 8 - strs.shape[1])))
    return cols


def dist_counters(out: dict) -> dict:
    return {k: int(out[k]) for k in ("nunique_r", "nunique_s", "merge_nres", "hash_nres",
                                     "agg_groups")}


def check_dist_run(out: dict, want: dict, single: dict, field: int, what: str) -> dict:
    got = dist_counters(out)
    for k, v in got.items():
        if v != want[k] or v != single.get(k, v):
            raise AssertionError(f"[dist] {what}: {k} = {v}, numpy says {want[k]}, the "
                                 f"single-card pipeline {single.get(k)}")
    if int(out["overflow"]):
        raise AssertionError(f"[dist] {what}: overflow {int(out['overflow'])}")
    keys = []
    for b, c in zip(out["join_out"], out["join_counts"]):
        keys.append(dist_key_ids(dist_key_cols(b.slice(0, int(c)), field), field))
    if not np.array_equal(np.sort(np.concatenate(keys)), want["keys"]):
        raise AssertionError(f"[dist] {what}: the join rows' keys differ from numpy's")
    return got


def dist_run(name: str, fn, kernels, runs: dict):
    """One run with the launch counters set to 0 just before and read just
    after; every kernel in `kernels` must have launched."""
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(LAUNCHES)
    check_launched(launches, kernels, f"[dist] {name}")
    runs[name] = {"launches": launches, "wall_ms": wall}
    return out


def dist_kernel_edges(g, dev) -> dict:
    """K19-K22 and K9's fill against their plain versions at their edges."""
    from database_technology_algorithms_tpu_torch.kernels import dist_plan
    from database_technology_algorithms_tpu_torch.kernels.hot_set import (
        hot_hashes, hot_hashes_plain, hot_lists, hot_lists_plain, in_hot_set, in_hot_set_plain)
    from database_technology_algorithms_tpu_torch.kernels.range_dest import (
        range_dest, range_dest_plain)
    from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
        stage_to_cells, stage_to_cells_plain)
    from database_technology_algorithms_tpu_torch.kernels.topk_runs import (
        topk_runs, topk_runs_plain)

    errs = dict.fromkeys(("topk_runs", "hot_hashes", "in_hot_set", "range_dest", "stage_cells"), 0)
    m32 = 0xFFFFFFFF
    tile = dist_plan.TOPK_TILE
    # K19: n < k, one run, all dead, ties at the k-th place, a run across every tile;
    # each at k = 16 (a warp's list in its lanes) and, where n allows, 33 and 1024 (the
    # block's list in shared memory)
    for what, h, nact, k in (
            ("n < k", g.integers(0, 9, 5), 4, 5),
            ("one run", np.full(70_001, 2**31 + 5), 70_001, 16),
            ("all dead", g.integers(0, 2**32, 5000), 0, 16),
            ("ties at the k-th place", np.repeat(np.arange(300), 7)[:2048], 2000, 16),
            ("a run across every tile", np.concatenate([np.full(16 * tile, 3),
                                                        g.integers(4, 2**32, 999)]),
             16 * tile + 900, 16),
            ("zipf", g.zipf(1.2, ROWS) % 100_000 * 2654435761 % 2**32, ROWS - 77, 16)):
        h = np.concatenate([np.sort(np.asarray(h[:nact], np.uint64)),
                            np.full(len(h) - nact, m32, np.uint64)])
        hs = u32_dev(h, dev)
        for kk in sorted({k, min(33, len(h)), min(1024, len(h))}):
            for cnt in (nact, torch.tensor(nact, dtype=torch.int32, device=dev)):
                errs["topk_runs"] = max(errs["topk_runs"], assert_same(
                    f"K19 {what} k={kk}", topk_runs(hs, cnt, kk), topk_runs_plain(hs, cnt, kk)))
    # K20: every candidate a sentinel, all equal, mixed; signed thresholds
    for what, m in (("every candidate a sentinel", 64), ("all candidates equal", 128),
                    ("mixed", 64), ("mixed", 1024)):
        gh = g.choice(np.array([5, 2**31 + 1, 9, m32], np.uint64), m)
        gh = np.full(m, m32) if what.startswith("every") else (
            np.full(m, 2**31 + 7) if what.startswith("all") else gh)
        gc = torch.from_numpy(g.integers(0, 2**20, m).astype(np.int32)).to(dev)
        for thr in (-1, 1, 50_000):
            errs["hot_hashes"] = max(errs["hot_hashes"], assert_same(
                f"K20 {what} m={m} threshold {thr}", (hot_hashes(u32_dev(gh, dev), gc, thr),),
                (hot_hashes_plain(u32_dev(gh, dev), gc, thr),)))
    # K20's two-sided launch (the skew join's): m of 0, 1, 64 a side and the limit a side
    # (grid mode), an all-sentinel side, duplicates across the shards' lists, sums that
    # wrap, a count whose threshold clamps to 1; hot and n_hot both
    k20_modes = set()
    pool = np.array([5, 2**31 + 1, 9, 12, m32], np.uint64)
    lim = dist_plan.HOT_MAX_CANDIDATES
    for what, m_p, m_b in (("empty", 0, 0), ("one a side", 1, 1), ("64 a side", 64, 64),
                           ("all-sentinel build side", 64, 64), ("wrapping sums", 64, 64),
                           ("64 and 1", 64, 1), ("probe side only", 64, 0),
                           ("the limit a side", lim, lim)):
        sides = []
        for side, m in (("p", m_p), ("b", m_b)):
            gh = np.resize(g.choice(pool, max(m // 4, 1)), m)  # 4 shards' lists repeat
            if what.startswith("all-sentinel") and side == "b":
                gh[:] = m32
            if what.startswith("the limit"):
                gh = g.integers(0, 3000, m, dtype=np.uint64) * 2654435761 % 2**32
            gc = g.integers(0, 400, m).astype(np.int32)
            if what == "wrapping sums":
                gc[:] = 2**30
            sides += [u32_dev(gh, dev), torch.from_numpy(gc).to(dev)]
        for tot_p, tot_b in ((50_000, 7), (15, 2**31 - 1)):  # 15 // 16 = 0: the clamp to 1
            args = (sides[0], sides[1], torch.tensor(tot_p, dtype=torch.int32, device=dev),
                    sides[2], sides[3], torch.tensor(tot_b, dtype=torch.int32, device=dev), 16)
            k20_modes.add(dist_plan.hot_plan(m_p, m_b).block)
            errs["hot_hashes"] = max(errs["hot_hashes"], assert_same(
                f"K20 two-sided, {what} ({m_p} + {m_b}), counts {tot_p}, {tot_b}",
                [x.reshape(-1) for x in hot_lists(*args)],
                [x.reshape(-1) for x in hot_lists_plain(*args)]))
    if k20_modes != {True, False}:
        raise AssertionError(f"K20's two-sided edges took block mode {sorted(k20_modes)} only")
    # K21: an empty hot list, none at all, a mixed one, duplicate entries, one entry, a
    # list past the scan (search mode) and a full one with many live; on 2M rows, 2M + 1
    # and 2M + 3 (the vector path's tail) and a view one word in (the scalar path), rows
    # of 0xFFFFFFFF among them
    base = g.integers(0, 2**32, 2 * ROWS + 4, dtype=np.uint64)
    base[::1000] = m32
    hashes = u32_dev(base, dev)
    views = {"2M rows": hashes[:2 * ROWS], "2M + 1": hashes[:2 * ROWS + 1],
             "2M + 3": hashes[:2 * ROWS + 3], "one word in": hashes[1:2 * ROWS + 1]}
    full = torch_host_pick(hashes, g, dist_plan.IN_SET_MAX_HOT)
    full[g.random(full.shape[0]) < 0.5] = m32
    lists = (("empty hot list", np.full(128, m32)), ("no entries", np.zeros(0)),
             ("mixed", np.where(np.arange(128) % 9 == 0, torch_host_pick(hashes, g, 128), m32)),
             ("duplicate entries", np.repeat(torch_host_pick(hashes, g, 8), 16)),
             ("one entry", torch_host_pick(hashes, g, 1)),
             ("past the scan", np.where(np.arange(dist_plan.IN_SET_SCAN_MAX + 44) % 3 == 0,
                                        torch_host_pick(hashes, g, dist_plan.IN_SET_SCAN_MAX + 44),
                                        m32)),
             (f"full, {int((full != m32).sum())} live", full))
    modes = set()
    for what, hot in lists:
        hot_t = u32_dev(hot, dev)
        for view, hh in views.items():
            if what.startswith("full") and view not in ("2M rows", "one word in"):
                continue
            plan = dist_plan.in_set_plan(hh.shape[0], hot_t.shape[0], hh.data_ptr(), 0)
            modes.add((plan.vec, plan.search))
            errs["in_hot_set"] = max(errs["in_hot_set"], assert_same(
                f"K21 {what}, {view}", (in_hot_set(hh, hot_t),), (in_hot_set_plain(hh, hot_t),)))
    if len(modes) != 4:
        raise AssertionError(f"K21's edges took {sorted(modes)} of its (vector, search) forms")
    # K22: 1 and 3 splitters, keys equal to a splitter, on both sides of 2^31, 1-4 words;
    # strided words (the scalar path), contiguous aligned ones (the vector path) with
    # n % 4 = 0-3 rows of tail, misaligned ones (a view one row in: the scalar path),
    # strided splitters
    pool = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, m32], np.uint64)
    strw = u32_dev(g.choice(pool, (ROWS + 3, 4)), dev)
    paths = {True: 0, False: 0}
    for nw in (1, 2, 3, 4):
        for ns in (1, 3):
            spl = np.sort(g.choice(pool, (ns, nw)).view(np.uint64), axis=0)
            spl = spl[np.lexsort(spl.T[::-1])]
            splt = [u32_dev(np.ascontiguousarray(spl[:, j]), dev) for j in range(nw)]
            spl_mat = u32_dev(spl, dev)
            layouts = [("strided", [strw[:ROWS, j] for j in range(nw)], splt),
                       ("strided splitters", [strw[:ROWS, j] for j in range(nw)],
                        [spl_mat[:, j] for j in range(nw)])]
            for tail in (0, 1, 2, 3):
                cols = [strw[:, j].contiguous() for j in range(nw)]
                layouts += [(f"contiguous, tail {tail}", [c[:ROWS + tail] for c in cols], splt),
                            (f"one row in, {ROWS + tail - 1} rows",
                             [c[1:ROWS + tail] for c in cols], splt)]
            for what, words, sp in layouts:
                vec = dist_plan.range_plan(words[0].shape[0], [w.data_ptr() for w in words],
                                           [w.stride(0) for w in words], 0)[0]
                paths[vec] += 1
                errs["range_dest"] = max(errs["range_dest"], assert_same(
                    f"K22 {nw} words, {ns} splitters, {what}", (range_dest(words, sp),),
                    (range_dest_plain(words, sp),)))
    if not paths[True] or not paths[False]:
        raise AssertionError(f"K22's edges took one path only: {paths}")
    # K9 with a fill: the overlap join's key-only pack
    dest = u32_dev(g.integers(0, DIST_SHARDS, ROWS), dev)
    pay = [u32_dev(g.integers(0, 2**32, ROWS, dtype=np.uint64), dev) for _ in range(2)]
    for fill in (0, m32, 0x12345678):
        for count in (None, ROWS - 1000):
            args = (dest, None, DIST_SHARDS, ROWS // DIST_SHARDS, pay, "slots")
            got = stage_to_cells(*args, count=count, fill=fill)
            want = stage_to_cells_plain(*args, count=count, fill=fill)
            errs["stage_cells"] = max(errs["stage_cells"], assert_same(
                f"K9 fill {fill:#x} count {count}", [*got[0], got[1], got[2], got[3].reshape(1)],
                [*want[0], want[1], want[2], want[3].reshape(1)]))
    torch.cuda.synchronize()
    log("[kernels] K19-K22 and K9's fill equal their plain versions at their edges (K19: n < k, "
        "one run, all dead, ties at the k-th place, a run across 16 tiles, 1M Zipf hashes, the "
        "count on the host and the card, each at k = 16, 33 and 1024 where n allows; K20: every candidate a sentinel, all equal, mixed, "
        "thresholds -1, 1, 50000; K20 two-sided (hot and n_hot) at 0, 1 and 64 candidates a "
        "side, 64 and 1, one side, the limit a side (grid mode), an all-sentinel side, wrapping "
        "sums, a threshold clamped to 1, in both modes; K21: an empty hot list, no entries, "
        "a mixed one, duplicate entries, one entry, a list past the scan and a full one "
        "(IN_SET_MAX_HOT, half live) over 2M rows, 2M + 1, 2M + 3 and a view one word in, rows of 0xFFFFFFFF among them, both "
        "paths in both modes; "
        f"K22: 1-4 words, 1 and 3 splitters, keys equal to a splitter and on both sides of "
        f"2^31, strided ({paths[False]} calls on the scalar path, with the views one row in) "
        f"and contiguous with 0-3 rows of tail ({paths[True]} on the vector path), strided "
        f"splitters; K9: fills 0, 0xFFFFFFFF and 0x12345678 with and without a live count)")
    return errs


def torch_host_pick(t: torch.Tensor, g, m: int) -> np.ndarray:
    """m values of an int32 tensor holding u32, as numpy u32 (hashes that occur)."""
    return u32_host(t[torch.from_numpy(g.integers(0, t.shape[0], m)).to(t.device)]).astype(
        np.uint64)


def dist_kernels_on(captured: dict) -> dict:
    """K19-K22, K9's fill and K15 (the overlap engine's probe) against their
    plain versions on the arguments the runs gave them
    (captured[run][kernel])."""
    from database_technology_algorithms_tpu_torch.kernels import hot_set, range_dest, stage_cells
    from database_technology_algorithms_tpu_torch.kernels import sorted_probe as k15
    from database_technology_algorithms_tpu_torch.kernels import topk_runs as k19

    pairs = {"sorted_probe": (k15.sorted_probe, k15.sorted_probe_plain),
             "topk_runs": (k19.topk_runs, k19.topk_runs_plain),
             "hot_lists": (hot_set.hot_lists, hot_set.hot_lists_plain),
             "in_hot_set": (hot_set.in_hot_set, hot_set.in_hot_set_plain),
             "range_dest": (range_dest.range_dest, range_dest.range_dest_plain),
             "stage_to_cells": (stage_cells.stage_to_cells, stage_cells.stage_to_cells_plain)}

    errs = dict.fromkeys(pairs, 0)
    for run, calls in captured.items():
        for what, (args, kw) in calls.items():
            name = what.split()[0]
            kern, plain = pairs[name]
            errs[name] = max(errs[name], assert_same(
                f"{name} on the inputs of the dist run '{run}'", flat_tensors(kern(*args, **kw)),
                flat_tensors(plain(*args, **kw))))
    torch.cuda.synchronize()
    log(f"[kernels] K19-K22, K9's fill and K15 equal their plain versions on the inputs of "
        f"{len(captured)} dist runs (each kernel's first call in each); max abs err {errs}")
    return errs


def phase_dist(dev, card: str) -> dict:
    """The distributed plan on a mesh of DIST_SHARDS shards on the one card
    (``make_dist_pipeline``, the distributed operators, the skew join of
    BASELINE config 4, a 3-shard mesh and the CLI's ``pipeline --dist 4``),
    each run against numpy and the single-card pipeline, with the launch
    counters set to 0 around each run; K19-K22 and K9's fill against their
    plain versions at their edges and on the runs' own inputs; the timed
    16M + 16M run by stage."""
    import tempfile

    from database_technology_algorithms_tpu_torch.config import EngineConfig
    from database_technology_algorithms_tpu_torch.io.blockfile import read_blockfile_numpy
    from database_technology_algorithms_tpu_torch.models import pipeline as tpipe
    from database_technology_algorithms_tpu_torch.parallel import dist_ops, overlap, skew
    from database_technology_algorithms_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.time()
    marks = [("start", t_phase)]

    def mark(name: str) -> None:
        torch.cuda.synchronize()
        marks.append((name, time.time()))

    g = np.random.default_rng(19)
    errs = dist_kernel_edges(g, dev)
    mark("kernel edges")
    mesh = make_mesh(devices=[dev] * DIST_SHARDS)
    runs: dict = {}
    captured: dict = {}
    cfg = EngineConfig()

    def record(name, fn):
        """fn() with the first call of each of K19-K22 and of K9 with a fill
        kept as captured[name][kernel]."""
        with contextlib.ExitStack() as stack:
            calls = {n: stack.enter_context(recorded_calls(m, n)) for m, n in DIST_RECORDED}
            out = fn()
        captured[name] = {n: next(x for x in c if n != "stage_to_cells" or x[1].get("fill"))
                          for n, c in calls.items()
                          if any(n != "stage_to_cells" or kw.get("fill") for _, kw in c)}
        packs = [x for x in calls["stage_to_cells"] if not x[1].get("fill")]
        if packs:  # the shuffle's pack with the most payload words
            captured[name]["stage_to_cells pack"] = max(packs, key=lambda x: len(x[0][4]))
        return out

    # ---- make_dist_pipeline: 4 shards, 4M + 4M, fields 0-3 x engines -----------------
    r_cols, s_cols = dist_cols(DIST_ROWS, 42), dist_cols(DIST_ROWS, 43, recid_start=DIST_ROWS // 2)
    t1, t2 = dist_ops.distribute(mesh, r_cols), dist_ops.distribute(mesh, s_cols)
    r_b, s_b = to_batch(r_cols, dev), to_batch(s_cols, dev)
    mark("data")
    for field in (1, 0, 2, 3):
        want = dist_oracle(r_cols, s_cols, field)
        mark(f"field {field}'s oracle")
        single_out = tpipe.make_pipeline_staged(field)(r_b, s_b)
        single = {k: int(single_out[k]) for k in ("nunique_r", "nunique_s", "merge_nres",
                                                  "hash_nres", "agg_groups")}
        mark(f"field {field}'s single-card counters")
        for engine, nchunks in [(e, 1) for e in DIST_ENGINES] + [("sorted", 4)]:
            name = f"field {field}, {engine}, nchunks {nchunks}"
            ecfg = EngineConfig(dist_join_engine=engine, shuffle_nchunks=nchunks)
            step = tpipe.make_dist_pipeline(mesh, field, ecfg)
            kernels = DIST_KERNELS + DIST_ENGINE_KERNELS[engine] + (
                ("sorted_probe",) if engine == "overlap" and field in (0, 1) else ()) + (
                ("member_mult",) if engine == "overlap" and field in (2, 3) else ())
            out = dist_run(name, lambda: record(name, lambda: step(
                t1.batches, t1.counts, t2.batches, t2.counts)), kernels, runs)
            got = check_dist_run(out, want, single, field, name)
            del out
            timed = ""
            if field == 1 and nchunks == 1 and engine != "overlap":  # device time, warm wall
                prof = profile_device(lambda: step(t1.batches, t1.counts, t2.batches, t2.counts),
                                      reps=2, cpu=False)
                runs[name].update(device_ms=prof["busy_us"] / 1e3, warm_wall_ms=wall_ms(
                    lambda: step(t1.batches, t1.counts, t2.batches, t2.counts), reps=3))
                timed = (f"; warm host wall {runs[name]['warm_wall_ms']:.2f} ms (median of 3), "
                         f"device {runs[name]['device_ms']:.2f} ms ({device_parts(prof)})")
            log(f"[dist] {card}: {DIST_SHARDS} shards, {DIST_ROWS} + {DIST_ROWS} rows, {name}: "
                f"{got} == numpy and the single-card pipeline, overflow 0; host wall "
                f"{runs[name]['wall_ms']:.1f} ms (first run){timed}; launches "
                + ", ".join(f"{k} {runs[name]['launches'][k]}" for k in kernels))
            if field == 1:
                mark(name)
        if field == 1:
            staged = tpipe.make_pipeline_staged(1)
            prof = profile_device(lambda: staged(r_b, s_b), reps=2, cpu=False)
            runs["single card"] = {"device_ms": prof["busy_us"] / 1e3,
                                   "wall_ms": wall_ms(lambda: staged(r_b, s_b), reps=3)}
            log(f"[dist] {card}: the single-card staged pipeline on the same {DIST_ROWS} + "
                f"{DIST_ROWS} rows, field 1: host wall {runs['single card']['wall_ms']:.2f} ms, "
                f"device {runs['single card']['device_ms']:.2f} ms ({device_parts(prof)})")
        mark(f"field {field}'s runs")
    del r_b, s_b
    # ---- BASELINE config 4: Zipf 1.2 keys, the skew join beside the plain one ----------
    zb, zp = dist_cols(DIST_ROWS, 44, zipf_a=1.2), dist_cols(DIST_ROWS, 45, zipf_a=1.2)
    zb["valid"][:] = True
    zp["valid"][:] = True
    tb, tp = dist_ops.distribute(mesh, zb), dist_ops.distribute(mesh, zp)
    hit = np.isin(zp["num"], zb["num"])
    want_rows = np.sort(zp["recid"][hit])
    for name, fn, kernels in (
            ("zipf, dist_hash_join_skew", lambda: skew.dist_hash_join_skew(mesh, tb, tp, 1),
             ("topk_runs", "hot_hashes", "in_hot_set", "stage_cells")),
            ("zipf, dist_hash_join", lambda: dist_ops.dist_hash_join(mesh, tb, tp, 1),
             ("stage_cells", "compact")),
            ("zipf, dist_hash_join_overlapped",
             lambda: overlap.dist_hash_join_overlapped(mesh, tb, tp, 1), ("stage_cells",
                                                                         "sorted_probe"))):
        res = dist_run(name, lambda: record(name, fn), kernels, runs)
        table, nres, ovf = res[0], int(res[1]), int(res[2])
        rows = np.sort(dist_ops.collect(table)["recid"])
        if nres != int(hit.sum()) or ovf or not np.array_equal(rows, want_rows):
            raise AssertionError(f"[dist] {name}: nres {nres}, overflow {ovf}, numpy "
                                 f"{int(hit.sum())}, rows equal: {np.array_equal(rows, want_rows)}")
        extra = f", n_hot {int(res[3])}" if len(res) == 4 else ""
        log(f"[dist] {card}: BASELINE config 4, {DIST_SHARDS} shards, {DIST_ROWS} + {DIST_ROWS} "
            f"Zipf 1.2 keys, {name}: {nres} probe rows == numpy, overflow 0{extra}; host wall "
            f"{runs[name]['wall_ms']:.1f} ms")
    if "stage_to_cells" not in captured["zipf, dist_hash_join_overlapped"]:
        raise AssertionError("[dist] the overlapped join never called K9 with its fill")
    # the skew step's launches in the order they ran (dist_records counts them by name)
    runs["zipf, dist_hash_join_skew"]["in_order"] = launches_in_order(
        lambda: skew.dist_hash_join_skew(mesh, tb, tp, 1), reps=3)
    del tb, tp
    mark("config 4")
    # ---- dist_sort, dist_distinct, dist_aggregate, 4M rows ---------------------------
    keys = r_cols["num"]
    for name, fn, kernels in (
            ("dist_sort", lambda: dist_ops.dist_sort(mesh, t1, 1),
             ("range_dest", "words_sort", "stage_cells")),
            ("dist_distinct", lambda: dist_ops.dist_distinct(mesh, t1, 1), ("stage_cells",)),
            ("dist_aggregate", lambda: dist_ops.dist_aggregate(mesh, t1, 1),
             ("stage_cells", "run_aggregate"))):
        res = dist_run(name, lambda: record(name, fn), kernels, runs)
        if int(res[-1]):
            raise AssertionError(f"[dist] {name}: overflow {int(res[-1])}")
        got = dist_ops.collect(res[0])["num"]
        if name == "dist_sort":
            ok = np.array_equal(got, np.sort(keys))
        elif name == "dist_distinct":
            ok = int(res[1]) == len(np.unique(keys)) and np.array_equal(np.sort(got),
                                                                          np.unique(keys))
        else:
            u, c = np.unique(keys, return_counts=True)
            order = np.argsort(got, kind="stable")
            counts = np.concatenate([a["count"][: int(n)].cpu().numpy()
                                     for a, n in zip(res[1], res[0].counts)])[order]
            sums = np.concatenate([u32_host(a["sum"][: int(n)])
                                   for a, n in zip(res[1], res[0].counts)])[order]
            ok = (np.array_equal(got[order], u) and np.array_equal(counts, c)
                  and np.array_equal(sums, (u.astype(np.uint64) * c % 2**32).astype(np.uint32)))
        if not ok:
            raise AssertionError(f"[dist] {name}: differs from numpy")
        log(f"[dist] {card}: {name}, {DIST_SHARDS} shards, {DIST_ROWS} rows, field 1: == numpy "
            f"(all rows, the invalid ones included, as the operator takes them); host wall "
            f"{runs[name]['wall_ms']:.1f} ms")
    del t1, t2
    mark("operators")
    # ---- a 3-shard mesh, 3M + 3M: the unsigned modulo at ndev 3 ----------------------
    mesh3 = make_mesh(devices=[dev] * 3)
    r3, s3 = dist_cols(DIST_SMALL_ROWS, 46), dist_cols(DIST_SMALL_ROWS, 47)
    t31, t32 = dist_ops.distribute(mesh3, r3), dist_ops.distribute(mesh3, s3)
    want = dist_oracle(r3, s3, 1)
    for engine in ("sorted", "skew"):
        name = f"3 shards, field 1, {engine}"
        step = tpipe.make_dist_pipeline(mesh3, 1, EngineConfig(dist_join_engine=engine))
        out = dist_run(name, lambda: step(t31.batches, t31.counts, t32.batches, t32.counts),
                       DIST_KERNELS + DIST_ENGINE_KERNELS[engine], runs)
        got = check_dist_run(out, want, {}, 1, name)
        log(f"[dist] {card}: {name}, {DIST_SMALL_ROWS} + {DIST_SMALL_ROWS} rows: {got} == numpy")
    del t31, t32
    mark("3 shards")
    # ---- the CLI: pipeline --dist 4 on block files -----------------------------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_dist_") as tmp:
        for engine in DIST_ENGINES:
            argv = ["pipeline", "--dist", str(DIST_SHARDS), "--nblocks", str(DIST_NBLOCKS),
                    "--field", "1", "--join-engine", engine, "--workdir", tmp]
            t0 = time.perf_counter()
            rc, line = run_cli(argv)
            wall = time.perf_counter() - t0
            files = [read_blockfile_numpy(os.path.join(tmp, f)) for f in ("file.bin",
                                                                           "file2.bin")]
            for f in files:
                f["valid"] = np.asarray(f["valid"], bool)
            want = dist_oracle(*files, 1)
            if rc or not line["joins_agree"] or line["merge_join_pairs"] != want["merge_nres"] \
                    or line["nunique_r"] != want["nunique_r"] or line["overflow"]:
                raise AssertionError(f"[dist] pipeline --dist {DIST_SHARDS} --join-engine "
                                     f"{engine}: rc {rc}, {line}, numpy {want}")
            log(f"[dist] {card}: `{' '.join(argv[:-2])}`: exit 0, {line}, == numpy; "
                f"{wall:.2f} s with the files")
    mark("cli")
    # ---- K19-K22 and K9's fill on the runs' own inputs -------------------------------
    for k, e in dist_kernels_on(captured).items():
        key = {"stage_to_cells": "stage_cells", "hot_lists": "hot_hashes"}.get(k, k)
        errs[key] = max(errs.get(key, 0), e)
    mark("own inputs")
    # ---- the timed run: 16M + 16M, field 1, sorted, by stage -------------------------
    big_r, big_s = dist_cols(DIST_BIG_ROWS, 48), dist_cols(DIST_BIG_ROWS, 49)
    mark("timed run's data")
    b1, b2 = dist_ops.distribute(mesh, big_r), dist_ops.distribute(mesh, big_s)
    mark("timed run's distribute")
    want = dist_oracle(big_r, big_s, 1)
    mark("timed run's oracle")
    step = tpipe.make_dist_pipeline(mesh, 1, cfg)
    name = f"{DIST_BIG_ROWS} + {DIST_BIG_ROWS} rows, field 1, sorted"
    out = dist_run(name, lambda: step(b1.batches, b1.counts, b2.batches, b2.counts),
                   DIST_KERNELS + DIST_ENGINE_KERNELS["sorted"], runs)
    got = check_dist_run(out, want, {}, 1, name)
    del out
    mark("timed run's check")
    stages = dist_stage_times(mesh, b1, b2, cfg, card)
    whole_wall = wall_ms(lambda: step(b1.batches, b1.counts, b2.batches, b2.counts), reps=3)
    device = sum(st["device_ms"] for st in stages.values())
    runs["big"] = {"wall_ms": whole_wall, "device_ms": device, "stages": stages}
    log(f"[dist] {card}: {DIST_SHARDS} shards, {name}: {got} == numpy; the step: host wall "
        f"{whole_wall:.2f} ms (median of 3), device {device:.2f} ms (its stages' sum)")
    del b1, b2
    mark("timed run's stages")
    recs = dist_records(captured, runs, errs, card)
    mark("records")
    took = time.time() - t_phase
    log("[dist] seconds: " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks[:-1], marks[1:])))
    log(f"[dist] the phase took {took:.1f} s (limit {DIST_PHASE_LIMIT_S:.0f} s)")
    if took > DIST_PHASE_LIMIT_S:
        raise AssertionError(f"[dist] the phase took {took:.1f} s, past its limit of "
                             f"{DIST_PHASE_LIMIT_S:.0f} s")
    return {"recs": recs, "runs": runs, "errs": errs}


def dist_stage_times(mesh, b1, b2, cfg, card: str) -> dict:
    """The timed run's three stages on their own: host wall (median of 3
    synchronized runs) and device time (torch.profiler, mean of 3)."""
    from database_technology_algorithms_tpu_torch.models import pipeline as tpipe

    ndev = len(mesh.devices)
    cap_r, cap_s = tpipe._dist_caps(b1.rows_per_chip, b2.rows_per_chip, ndev, cfg)

    def local():
        return [tpipe._dist_stage_local(a, b, c, d, 1, cfg)
                for a, b, c, d in zip(b1.batches, b1.counts, b2.batches, b2.counts)]

    loc = [list(x) for x in zip(*local())]

    def shuffled():
        return tpipe._dist_stage_shuffle(mesh, *loc, 1, cfg, cap_r, cap_s)

    sh = shuffled()

    def join():
        return tpipe._dist_stage_join(mesh, *sh[:5], 1, cfg, cap_r, cap_s)

    out = {}
    for name, fn in (("local", local), ("shuffle", shuffled), ("join", join)):
        wall = wall_ms(fn, reps=3)
        prof = profile_device(fn, reps=2, cpu=False)
        out[name] = {"wall_ms": wall, "device_ms": prof["busy_us"] / 1e3,
                     "parts": device_parts(prof, top=4)}
        log(f"[dist] {card}: stage {name}: host wall {wall:.2f} ms, device "
            f"{prof['busy_us'] / 1e3:.2f} ms ({out[name]['parts']})")
    return out


def dist_records(captured: dict, runs: dict, errs: dict, card: str) -> list[dict]:
    """The kernels line's entries of K19-K22 at the runs' shapes, and K9's
    time at the shuffle's pack (logged)."""
    from database_technology_algorithms_tpu_torch.batch import as_u32
    from database_technology_algorithms_tpu_torch.kernels import hot_set, range_dest, stage_cells
    from database_technology_algorithms_tpu_torch.kernels import topk_runs as k19

    skew_run = runs["zipf, dist_hash_join_skew"]["launches"]
    sort_run = runs["dist_sort"]["launches"]
    zipf = captured["zipf, dist_hash_join_skew"]
    out = []
    (hs, nact, k), _ = zipf["topk_runs"]
    n = hs.shape[0]
    sel = dist_selection_keys(hs, nact)
    out.append(dict(name="topk_runs", source="csrc/topk_runs.cu",
                    replaces="parallel/skew.py:44", launches=skew_run["topk_runs"],
                    kern=lambda: k19.topk_runs(hs, nact, k),
                    plain=lambda: k19.topk_runs_plain(hs, nact, k),
                    lib=lambda: torch.topk(sel, k), lib_name="torch.topk of the (count, "
                    "position) keys: the selection alone",
                    nbytes=4 * n + 8 * k, nops=2 * n, shape=f"{n} sorted hashes, k = {k}"))
    k20_args, _ = zipf["hot_lists"]
    m_p, m_b = k20_args[0].shape[0], k20_args[3].shape[0]
    if skew_run["hot_hashes"] != 1:
        raise AssertionError(f"[dist] the {DIST_SHARDS}-shard skew join on one card launched K20 "
                             f"{skew_run['hot_hashes']} times, not once")
    out.append(dict(name="hot_hashes", source="csrc/hot_set.cu", replaces="parallel/skew.py:68",
                    launches=skew_run["hot_hashes"], kern=lambda: hot_set.hot_lists(*k20_args),
                    plain=lambda: hot_set.hot_lists_plain(*k20_args), lib=None,
                    lib_name=None, nbytes=12 * (m_p + m_b) + 12, nops=m_p * m_p + m_b * m_b,
                    # candidates and counts in, the list, two counts and n_hot
                    shape=f"{m_p} + {m_b} gathered candidates, both sides in one launch"))
    (hh, hot), _ = zipf["in_hot_set"]
    nh, mh = hh.shape[0], hot.shape[0]
    live = hot[hot != -1]
    out.append(dict(name="in_hot_set", source="csrc/hot_set.cu", replaces="parallel/skew.py:91",
                    launches=skew_run["in_hot_set"], kern=lambda: hot_set.in_hot_set(hh, hot),
                    plain=lambda: hot_set.in_hot_set_plain(hh, hot),
                    lib=lambda: torch.isin(hh, live), lib_name="torch.isin of the live entries",
                    nbytes=5 * nh + 4 * mh, nops=nh * max(live.shape[0], 1),
                    shape=f"{nh} row hashes, {mh} hot entries ({live.shape[0]} live)"))
    (words, spl), _ = captured["dist_sort"]["range_dest"]
    nr, nw, ns = words[0].shape[0], len(words), spl[0].shape[0]
    lib = None
    if nw == 1:
        s64, w64 = as_u32(spl[0]).contiguous(), as_u32(words[0])
        lib = lambda: torch.searchsorted(s64, w64, right=True)  # noqa: E731
    out.append(dict(name="range_dest", source="csrc/range_dest.cu",
                    replaces="parallel/dist_ops.py:312", launches=sort_run["range_dest"],
                    kern=lambda: range_dest.range_dest(words, spl),
                    plain=lambda: range_dest.range_dest_plain(words, spl), lib=lib,
                    lib_name="torch.searchsorted(right=True) of the u32 values",
                    nbytes=4 * nw * nr + 4 * nw * ns + 4 * nr, nops=nr * ns * nw,
                    shape=f"{nr} keys of {nw} word(s), {ns} splitters"))
    recs = []
    for sp in out:
        bound, by = bound_of(sp["nbytes"], sp["nops"])
        rec = {"name": sp["name"], "route": "cuda", "source": f"{PKG}/{sp['source']}",
               "replaces": f"{JAX_PKG}/{sp['replaces']}", "launches": sp["launches"],
               "max_abs_err": errs[sp["name"]], "ms": device_ms(sp["kern"], cpu=False),
               "plain_ms": device_ms(sp["plain"], cpu=False), "bound_ms": bound, "bound_by": by,
               "library_ms": device_ms(sp["lib"], cpu=False) if sp["lib"] is not None else None,
               "shape": sp["shape"]}
        log(f"[timing] {card}: {sp['name']} ({sp['shape']}): device time per call: kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            + (f"{sp['lib_name']} {rec['library_ms']:.4f} ms" if sp["lib"] is not None
               else "none")
            + f", bound {bound:.4f} ms ({sp['nbytes']} B, {sp['nops']} ops, by {by}); launches "
            f"a run {rec['launches']}")
        recs.append(rec)
    recs[0].update(dist_k19_readings(hs, nact, k, sel, card))
    steps = runs["zipf, dist_hash_join_skew"]["in_order"]
    by_name = collections.Counter(name for name, _ in steps).most_common()
    recs[1]["skew_step"] = {"kernels": len(steps), "device_ms": sum(ms for _, ms in steps),
                            "by_name": dict(by_name)}
    log(f"[dist] {card}: the {DIST_SHARDS}-shard Zipf skew step launches {len(steps)} kernels "
        f"and memsets ({recs[1]['skew_step']['device_ms']:.4f} ms of device time, means of 3 "
        f"steps), K20 {dict(by_name).get('hot_lists_kernel', 0)} time(s): "
        + ", ".join(f"{name} x{n}" for name, n in by_name))
    (uh, uhot), _ = captured["field 1, skew, nchunks 1"]["in_hot_set"]
    recs[2].update(dist_k21_readings(hh, hot, uh, uhot, card))
    recs[-1].update(dist_k22_readings(words, spl, lib, card))
    # K9 at the shuffle's pack and with the overlap join's fill (their own rows in PERF.md)
    for what, run, key in (
            ("the shuffle's pack, the 4M + 4M field-1 sorted run", "field 1, sorted, nchunks 1",
             "stage_to_cells pack"),
            ("with fill 0xFFFFFFFF, the overlapped join's key-only pack",
             "zipf, dist_hash_join_overlapped", "stage_to_cells")):
        args, kw = captured[run][key]
        n, nparts, cap, w = args[0].shape[0], args[2], args[3], len(args[4])
        live = n if kw.get("count") is None else int(kw["count"])
        # the live rows' dest and words read; every slot of every word written
        # once (staged or filled), the counts, and a slot a row
        nbytes = live * (4 + 4 * w) + nparts * cap * 4 * w + nparts * 4 + n * 4
        bound, by = bound_of(nbytes, live * 8 + nparts * cap)
        log(f"[timing] {card}: stage_cells, {what} ({n} rows, {live} live, {nparts} cells of "
            f"{cap}, {w} word(s)): device time per call: kernel "
            f"{device_ms(lambda: stage_cells.stage_to_cells(*args, **kw), cpu=False):.4f} ms, "
            f"plain "
            f"{device_ms(lambda: stage_cells.stage_to_cells_plain(*args, **kw), cpu=False):.4f} "
            f"ms, bound {bound:.4f} ms ({nbytes} B, by {by}); launches a run "
            f"{runs[run]['launches']['stage_cells']}")
    return recs


def dist_k19_readings(hs: torch.Tensor, nact, k: int, sel: torch.Tensor, card: str) -> dict:
    """K19 on the skew join's own shard: the device events of one wrapper
    call (its memset and its one kernel) with their times, and at k = 33
    and 1024 (the block's list in shared memory) against its plain version,
    timed beside torch.topk of the same (count, position) keys."""
    from database_technology_algorithms_tpu_torch.kernels import topk_runs as k19

    alone = profile_device(lambda: k19.topk_runs(hs, nact, k), reps=10, cpu=False)
    kernels = [n for n in alone["per_call"] if "Memset" not in n]
    if len(kernels) != 1 or "topk_kernel" not in kernels[0] or len(alone["per_call"]) != 2:
        raise AssertionError(f"K19's wrapper launched {alone['per_call']}, not one memset and "
                             f"one topk_kernel")
    out = {"by_launch": {launch_name(n): us / 1e3 for n, us in alone["top"]}}
    log(f"[timing] {card}: topk_runs (k = {k}), device ms a call by launch: "
        f"{device_parts(alone, top=3)}")
    n = hs.shape[0]
    for kk in (33, 1024):
        err = assert_same(f"K19 on the skew join's shard, k = {kk}", k19.topk_runs(hs, nact, kk),
                          k19.topk_runs_plain(hs, nact, kk))
        bound, by = bound_of(4 * n + 8 * kk, 2 * n)
        r = {"ms": device_ms(lambda: k19.topk_runs(hs, nact, kk), cpu=False),
             "plain_ms": device_ms(lambda: k19.topk_runs_plain(hs, nact, kk), cpu=False),
             "library_ms": device_ms(lambda: torch.topk(sel, kk), cpu=False),
             "bound_ms": bound, "max_abs_err": err}
        out[f"k{kk}"] = r
        log(f"[timing] {card}: topk_runs ({n} sorted hashes, k = {kk}): device time per call: "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library torch.topk of the "
            f"(count, position) keys {r['library_ms']:.4f} ms, bound {bound:.4f} ms (by {by}); "
            f"equal to the plain version")
    return out


def dist_k21_readings(hh: torch.Tensor, hot: torch.Tensor, uh: torch.Tensor,
                      uhot: torch.Tensor, card: str) -> dict:
    """K21's wrapper on the Zipf shard launches one kernel and nothing else;
    K21 on the uniform shard of the field-1 skew run, and on a full list
    (``IN_SET_MAX_HOT`` entries of hashes that occur, a third live: the
    list sorted in shared memory and searched), each against its plain
    version, timed beside torch.isin of the live entries."""
    from database_technology_algorithms_tpu_torch.kernels import dist_plan, hot_set

    alone = profile_device(lambda: hot_set.in_hot_set(hh, hot), reps=10, cpu=False)
    if len(alone["per_call"]) != 1 or "in_hot_set_kernel" not in alone["per_call"][0]:
        raise AssertionError(f"K21's wrapper launched {alone['per_call']}, not one kernel")
    g = np.random.default_rng(21)
    full = hh[torch.from_numpy(g.integers(0, hh.shape[0], dist_plan.IN_SET_MAX_HOT)).to(
        hh.device)]
    full[torch.from_numpy(g.random(full.shape[0]) < 2 / 3).to(hh.device)] = -1
    out = {}
    for what, h, lst in (("uniform", uh, uhot), ("full_list", hh, full)):
        err = assert_same(f"K21 {what}", (hot_set.in_hot_set(h, lst),),
                          (hot_set.in_hot_set_plain(h, lst),))
        live = lst[lst != -1]
        plan = dist_plan.in_set_plan(h.shape[0], lst.shape[0], h.data_ptr(), 0)
        nops = h.shape[0] * max(live.shape[0], 1)
        if plan.search:  # one sort of the live entries and a search of them a row
            p = 1 << max(live.shape[0] - 1, 0).bit_length()
            stages = p.bit_length() - 1
            nops = (h.shape[0] * max(live.shape[0] - 1, 0).bit_length()
                    + p // 2 * stages * (stages + 1) // 2)
        bound, by = bound_of(5 * h.shape[0] + 4 * lst.shape[0], nops)
        r = {"ms": device_ms(lambda: hot_set.in_hot_set(h, lst), cpu=False),
             "plain_ms": device_ms(lambda: hot_set.in_hot_set_plain(h, lst), cpu=False),
             "library_ms": device_ms(lambda: torch.isin(h, live), cpu=False),
             "bound_ms": bound, "bound_by": by, "max_abs_err": err,
             "shape": f"{h.shape[0]} row hashes, {lst.shape[0]} entries ({live.shape[0]} live), "
                      f"{'search' if plan.search else 'scan'} mode"}
        out[what] = r
        log(f"[timing] {card}: in_hot_set, {what} ({r['shape']}): device time per call: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library torch.isin of the live "
            f"entries {r['library_ms']:.4f} ms, bound {bound:.4f} ms (by {by}); equal to the "
            f"plain version")
    return out


def dist_k22_readings(words: list, spl: list, lib, card: str) -> dict:
    """K22's wrapper on dist_sort's own inputs launches one kernel and
    nothing else; K22 and torch.searchsorted(right=True) in turns in one
    profiled window (one-word keys); K22 at field 3's key: dist_sort's num
    column and 3 string words of a [rows, 8] matrix (strided), 3
    splitters."""
    from database_technology_algorithms_tpu_torch.kernels import range_dest

    def named(prof, name):
        return sum(us for n, us in prof["top"] if name in n) / 1e3

    alone = profile_device(lambda: range_dest.range_dest(words, spl), reps=10, cpu=False)
    if len(alone["per_call"]) != 1 or "range_dest" not in alone["per_call"][0]:
        raise AssertionError(f"K22's wrapper launched {alone['per_call']}, not K22 alone")
    out = {}
    if lib is not None:
        alt = profile_device(lambda: (range_dest.range_dest(words, spl), lib()), reps=20,
                             cpu=False)
        out["ms_alternating"] = named(alt, "range_dest")
        out["library_ms_alternating"] = alt["busy_us"] / 1e3 - out["ms_alternating"]
        log(f"[timing] {card}: range_dest and torch.searchsorted(right=True) in turns, one "
            f"profiled window of 20 pairs: kernel {out['ms_alternating']:.4f} ms, searchsorted "
            f"{out['library_ms_alternating']:.4f} ms a call ({device_parts(alt, top=3)})")
    n, ns = words[0].shape[0], spl[0].shape[0]
    g = np.random.default_rng(22)
    strw = u32_dev(g.integers(0, 2**32, (n, 8), dtype=np.uint64), words[0].device)
    f3 = [words[0]] + [strw[:, j] for j in range(3)]
    rows = torch.from_numpy(np.sort(g.choice(n, ns, replace=False))).to(words[0].device)
    keys = np.stack([u32_host(w[rows]) for w in f3], 1).astype(np.uint64)
    keys = keys[np.lexsort(keys.T[::-1])]
    f3_spl = [u32_dev(np.ascontiguousarray(keys[:, j]), words[0].device) for j in range(4)]
    err = assert_same("K22 at field 3's key", (range_dest.range_dest(f3, f3_spl),),
                      (range_dest.range_dest_plain(f3, f3_spl),))
    nbytes = 4 * 4 * n + 4 * 4 * ns + 4 * n
    bound, by = bound_of(nbytes, n * ns * 4)
    out["field3"] = {"ms": device_ms(lambda: range_dest.range_dest(f3, f3_spl), cpu=False),
                     "plain_ms": device_ms(lambda: range_dest.range_dest_plain(f3, f3_spl),
                                           cpu=False),
                     "bound_ms": bound, "max_abs_err": err,
                     "shape": f"{n} rows, 4 words (3 strided), {ns} splitters"}
    log(f"[timing] {card}: range_dest at field 3's key ({out['field3']['shape']}): device time "
        f"per call: kernel {out['field3']['ms']:.4f} ms, plain {out['field3']['plain_ms']:.4f} "
        f"ms, bound {bound:.4f} ms ({nbytes} B, by {by}); equal to the plain version")
    return out


def dist_selection_keys(hs: torch.Tensor, nact) -> torch.Tensor:
    """int64 (run count << 32 | ~position) of every position: what K19
    selects from, for the library's torch.topk."""
    n = hs.shape[0]
    from database_technology_algorithms_tpu_torch.batch import as_u32

    u = as_u32(hs)
    pos = torch.arange(n, device=hs.device)
    live = pos < nact
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=hs.device), u[1:] != u[:-1]])
    new_run &= live
    seg = (torch.cumsum(new_run, 0) - 1).clamp(min=0)
    cnt = torch.zeros(n, dtype=torch.int64, device=hs.device).index_add_(0, seg, live.long())
    run = torch.where(new_run, cnt[seg], 0)
    return (run << 32) | (~pos & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# phase 12: the multi-process plan, one process of four shards on the card (NCCL)

MULTIPROC_SHARDS = 4  # --local-devices: four shards of the one process on the card
COLLECTIVES = ("all_to_all_single", "all_gather", "all_reduce")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def counted_collectives(backends: list):
    """Count the ``torch.distributed`` collectives called inside, by name,
    and record the backend of every group ``multihost.initialize`` forms.
    The calls still run."""
    import torch.distributed as dist

    from database_technology_algorithms_tpu_torch.parallel import multihost

    counts = {name: 0 for name in COLLECTIVES}
    saved = {name: getattr(dist, name) for name in COLLECTIVES}
    init = multihost.initialize

    def wrap(name):
        def call(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return call

    def initialize(*a, **kw):
        mesh = init(*a, **kw)
        backends.append(dist.get_backend(mesh.group))
        return mesh

    for name in COLLECTIVES:
        setattr(dist, name, wrap(name))
    multihost.initialize = initialize
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
        multihost.initialize = init


def phase_multiproc(dev, card: str) -> dict:
    """``pipeline --coordinator`` as one process of four shards on the card:
    the group over NCCL (gloo on the CPU), the mesh's collectives over it,
    the counters against numpy, the single-card command and ``--dist 4``
    (the in-process mesh on the same card), the launch counters around the
    run; then a death after the "local" stage checkpointed (exit 17, the
    manifest and the process's shards left) and a resume that loads it."""
    import tempfile

    from database_technology_algorithms_tpu_torch.io.generator import generate_columns
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches

    t_phase = time.time()
    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    seed = 42
    want = command_oracle(generate_columns(NBLOCKS, seed=seed),
                          generate_columns(NBLOCKS, seed=seed + 1), 1)
    base = ["pipeline", "--nblocks", str(NBLOCKS), "--seed", str(seed), "--skip-files",
            "--field", "1"]

    def group(port: int) -> list:
        return ["--coordinator", f"localhost:{port}", "--num-processes", "1", "--process-id",
                "0", "--local-devices", str(MULTIPROC_SHARDS), "--init-timeout", "120",
                "--heartbeat-timeout", "120"]

    rc, single = run_cli(base)
    if rc or {k: single[k] for k in COMMAND_COUNTERS} != want:
        raise AssertionError(f"[multiproc] the single-card command: rc {rc}, {single}, "
                             f"numpy {want}")
    out = {"runs": {}}
    # the sorted engine's exchange and sums; the skew engine's all-gathers too
    for name, extra, engine, reps, needs in (
            ("--dist 4", ["--dist", str(MULTIPROC_SHARDS)], "sorted", 3, ()),
            ("one process of a group", None, "sorted", 3, ("all_to_all_single", "all_reduce")),
            ("one process of a group, skew", None, "skew", 1, COLLECTIVES)):
        walls = []
        for rep in range(reps):
            backends: list = []
            argv = base + (extra if extra is not None else group(free_port())) + [
                "--join-engine", engine]
            with counted_collectives(backends) as counts:
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                rc, line = run_cli(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(LAUNCHES)
            got = {k: line[k] for k in COMMAND_COUNTERS}
            if rc or got != want or line["overflow"] or not line["joins_agree"] \
                    or line["mesh_devices"] != MULTIPROC_SHARDS:
                raise AssertionError(f"[multiproc] {name}: rc {rc}, {line}, numpy {want}")
            check_launched(launches, DIST_KERNELS + DIST_ENGINE_KERNELS[engine],
                           f"[multiproc] {name}")
            if extra is None:
                if backends != [want_backend] or not all(counts[c] for c in needs):
                    raise AssertionError(f"[multiproc] {name}: groups {backends}, collectives "
                                         f"{counts}; want one {want_backend} group carrying "
                                         f"{needs}")
            elif any(counts.values()) or backends:
                raise AssertionError(f"[multiproc] {name}: the in-process mesh called "
                                     f"collectives {counts}")
            walls.append((line["wall_s"], wall))
        out["runs"][name] = {"step_wall_s": [w for w, _ in walls],
                             "command_wall_s": [w for _, w in walls],
                             "collectives": counts, "backend": backends,
                             "launches": {k: v for k, v in launches.items() if v}}
        log(f"[multiproc] {card}: `{' '.join(argv)}`: {json.dumps(got)} == numpy and the single "
            f"card; mesh_devices {line['mesh_devices']}; "
            + (f"one {backends[0]} group, collectives {counts}; " if extra is None else
               "the in-process mesh (copies); ")
            + f"step wall s ({reps} runs): " + ", ".join(f"{w:.4f}" for w, _ in walls)
            + "; the whole command s: " + ", ".join(f"{w:.3f}" for _, w in walls))
    # ---- a death after the "local" stage, then the resume, on the card ---------------
    with tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_stages_") as tmp:
        ck = os.path.join(tmp, "stages")
        try:
            run_cli(base + group(free_port()) + ["--stage-checkpoints", ck,
                                                 "--fail-after-stage", "local"])
            raise AssertionError("[multiproc] --fail-after-stage local: the run did not die")
        except SystemExit as e:
            if e.code != 17:
                raise AssertionError(f"[multiproc] --fail-after-stage local: exit {e.code}, not 17")
        left = sorted(os.listdir(ck))
        if not {"manifest.json", "local.p0.npz", "local.p0.meta.json"} <= set(left):
            raise AssertionError(f"[multiproc] after the death: {left}")
        reset_launches()
        rc, line = run_cli(base + group(free_port()) + ["--stage-checkpoints", ck])
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        got = {k: line[k] for k in COMMAND_COUNTERS}
        if rc or got != want or line.get("resumed_stages") != ["local"] or os.listdir(ck):
            raise AssertionError(f"[multiproc] the resume: rc {rc}, {line}, numpy {want}, "
                                 f"left {os.listdir(ck)}")
        check_launched(launches, ("stage_cells", "compact", "take_fill"),
                       "[multiproc] the resume")
    out["resume"] = {"left_after_death": left, "resumed_stages": line["resumed_stages"],
                     "step_wall_s": line["wall_s"]}
    log(f"[multiproc] {card}: --stage-checkpoints with --fail-after-stage local: exit 17, left "
        f"{left}; the re-run resumed {line['resumed_stages']}: {json.dumps(got)} == numpy, "
        f"its files removed")
    log(f"[multiproc] the phase took {time.time() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: the forms past the kernels' shared-memory limits, at the real sizes

LIMITS_TOPK = (1025, 4096)  # K19's k past TOPK_MAX_K = 1024
LIMITS_SHARDS_K20 = 32  # K20: 32 shards x hh_topk 1024 candidates a side, past 29,056
LIMITS_HOT = 65536  # K21: a list of hh_topk 1024 on 32 shards, both sides, past 58,108
LIMITS_SPLITTERS = 14999  # K22: 14,999 splitters of 4 words (dist_sort on 15,000 shards)
LIMITS_K22_ROWS = 65536
LIMITS_CELLS = 40000  # K9: the shuffle's pack over 40,000 shards, past 38,399 cells
LIMITS_CELL_CAP = 64
LIMITS_PROBE_SHARDS = 60000  # K9: _dest_ranks' ndev + 2 = 60,002 probes, past 58,111
LIMITS_BUILD = (1 << 30) + 1  # K10: a build of 2^30 + 1 rows, past MAX_TABLE_BUILD
LIMITS_QUERY = 1 << 20
# K1 and K5 past 2^30 rows: every key word below 2^24 but on LIMITS_SORT_OTHER
# rows (10 inactive, the rest with a high byte in each word), so that each
# word's top pass scatters with one digit holding all the other rows: 2^30 + 1
# at the first size, past a 30-bit count; then the 32-bit row index's limit
LIMITS_SORT_OTHER = 64
LIMITS_SORT_INACTIVE = 10
LIMITS_SORT_ROWS = ((1 << 30) + 1 + LIMITS_SORT_OTHER, (1 << 31) - 1)
LIMITS_SORT_DIGIT = 1 << 30  # rows of the big digit at least
LIMITS_SORT_CHUNK = 1 << 26  # rows a chunk of the checks on the card
LIMITS_SORT_PROBE = 1 << 24  # rows of the plain version's memory probe


def limits_reading(name: str, what: str, fn, card: str, launched: dict, kernels: tuple,
                   absent: tuple = (), reps: int = 10,
                   checked: str = "equal to its plain version and numpy") -> float:
    """The device time of one call of a lifted form (torch.profiler, mean of
    `reps` calls), and its launches: each of `kernels` at least once, none
    of `absent` (the kernel whose limit it passes)."""
    from database_technology_algorithms_tpu_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = {k: LAUNCHES[k] for k in kernels + absent}
    missing = [k for k in kernels if not counts[k]] + [k for k in absent if counts[k]]
    if missing:
        raise AssertionError(f"[limits] {name} ({what}) launched {counts}: expected each of "
                             f"{kernels} and none of {absent}")
    launched[name] = counts
    ms = profile_device(fn, reps=reps, cpu=False)["busy_us"] / 1e3
    log(f"[limits] {card}: {name} ({what}): {ms:.4f} ms of device time a call, launches "
        f"{counts}; {checked}")
    return ms


def big_sort_inputs(dev, n: int, nwords: int, seed: int) -> tuple[list, torch.Tensor]:
    """`nwords` key words (an [n, nwords] matrix's columns, strided where
    nwords > 1) below 2^24, drawn on the card from `seed`, and the inactive
    mask: LIMITS_SORT_INACTIVE of LIMITS_SORT_OTHER rows (among them the
    first and the last) inactive, the others with a random high byte in
    every word."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mat = torch.randint(0, 1 << 24, (n, nwords), generator=gen, dtype=torch.int32, device=dev)
    g = np.random.default_rng(seed)
    rows = np.concatenate([[0, n - 1], g.choice(n - 2, LIMITS_SORT_OTHER - 2, replace=False) + 1])
    high = g.integers(1, 256, size=(LIMITS_SORT_OTHER - LIMITS_SORT_INACTIVE, nwords))
    idx = torch.from_numpy(rows[LIMITS_SORT_INACTIVE:]).to(dev)
    mat[idx] |= torch.from_numpy((high << 24).astype(np.uint32).view(np.int32)).to(dev)
    inact = torch.zeros(n, dtype=torch.bool, device=dev)
    inact[torch.from_numpy(rows[:LIMITS_SORT_INACTIVE]).to(dev)] = True
    return ([mat.view(n)] if nwords == 1 else [mat[:, j] for j in range(nwords)]), inact


def largest_digits(words: list, inact, sched) -> list[int]:
    """The rows of each pass's largest digit (bucket of the 512), counted in
    chunks on the card."""
    from database_technology_algorithms_tpu_torch.kernels import radix_plan

    n = words[0].shape[0]
    hist = torch.zeros((len(sched), 512), dtype=torch.int64, device=words[0].device)
    for lo in range(0, n, LIMITS_SORT_CHUNK):
        ws = [w[lo:lo + LIMITS_SORT_CHUNK] for w in words]
        ia = None if inact is None else inact[lo:lo + LIMITS_SORT_CHUNK]
        for i, p in enumerate(sched):
            hist[i] += torch.bincount(radix_plan.pass_digits(ws, ia, p), minlength=512)
    return hist.max(1).values.tolist()


def sort_is_defined(what: str, words: list, inact, perm, s_act, s_key=None) -> None:
    """The stable sort's definition, in chunks on the card: perm is a
    permutation of the rows; (inact, words as u32, row index) increases
    strictly from each sorted row to the next (the keys non-decreasing, the
    row index increasing within ties); s_act = ~inact[perm] (all true with no
    mask) and s_key = words[0][perm]."""
    from database_technology_algorithms_tpu_torch.batch import as_u32

    n = perm.shape[0]
    seen = torch.zeros(n, dtype=torch.bool, device=perm.device)
    for lo in range(0, n, LIMITS_SORT_CHUNK):
        a, hi = max(lo - 1, 0), min(lo + LIMITS_SORT_CHUNK, n)
        p = perm[a:hi].long()
        if int(p.min()) < 0 or int(p.max()) >= n:
            raise AssertionError(f"[limits] {what}: perm[{a}:{hi}] leaves [0, {n})")
        seen[p] = True
        cols = ([] if inact is None else [inact[p].to(torch.int8)]) + [as_u32(w[p]) for w in words]
        cols.append(p)
        less = torch.zeros(hi - a - 1, dtype=torch.bool, device=p.device)
        same = torch.ones_like(less)
        for c in cols:
            less |= same & (c[:-1] < c[1:])
            same &= c[:-1] == c[1:]
        if not bool(less.all()):
            raise AssertionError(f"[limits] {what}: rows {a}-{hi} out of order")
        want_act = torch.ones_like(p, dtype=torch.bool) if inact is None else ~inact[p]
        if not torch.equal(s_act[a:hi], want_act):
            raise AssertionError(f"[limits] {what}: s_act differs from ~inact[perm] in {a}-{hi}")
        if s_key is not None and not torch.equal(s_key[a:hi], words[0][p]):
            raise AssertionError(f"[limits] {what}: s_key differs from key[perm] in {a}-{hi}")
    if not bool(seen.all()):
        raise AssertionError(f"[limits] {what}: perm is not a permutation")


def chunked_max_abs_err(a: tuple, b: tuple) -> int:
    worst = 0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        for lo in range(0, x.shape[0], LIMITS_SORT_CHUNK):
            xs, ys = x[lo:lo + LIMITS_SORT_CHUNK], y[lo:lo + LIMITS_SORT_CHUNK]
            worst = max(worst, int((xs.long() - ys.long()).abs().max()))
    return worst


def plain_bytes_a_row(plain, words: list, inact) -> float:
    """The plain version's peak of device memory a row, measured on the
    first LIMITS_SORT_PROBE rows."""
    m = LIMITS_SORT_PROBE
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = plain([w[:m] for w in words], inact[:m])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / m


def limits_big_sorts(dev, card: str, launched: dict, times: dict) -> None:
    """K1 and K5 (2 strided words, with the mask) past 2^30 rows: at each of
    LIMITS_SORT_ROWS, the passes the kernel scattered and their largest
    digits, then the kernel against its plain version where the plain
    version's reckoned peak (its bytes a row on LIMITS_SORT_PROBE rows, with
    10% to spare) fits the free memory beside the kernel's outputs, else
    against the stable sort's definition; then its device time and
    launches."""
    from database_technology_algorithms_tpu_torch.kernels import radix_plan
    from database_technology_algorithms_tpu_torch.kernels.radix_sort import (
        view_sort, view_sort_plain)
    from database_technology_algorithms_tpu_torch.kernels.words_sort import (
        words_sort, words_sort_plain)

    sorts = {"view_sort": (1, lambda w, ia: view_sort(ia, w[0])[:3],
                           lambda w, ia: view_sort_plain(ia, w[0])[:3], "radix_sort",
                           radix_plan.view_sort_schedule()),
             "words_sort": (2, lambda w, ia: words_sort(w, ia)[:2],
                            lambda w, ia: words_sort_plain(w, ia)[:2], "words_sort",
                            radix_plan.words_sort_schedule(2, True))}
    for n in LIMITS_SORT_ROWS:
        for name, (nwords, kernel, plain, counter, sched) in sorts.items():
            what = f"{n} rows, {nwords} word{'s' * (nwords > 1)} below 2^24 but on " \
                   f"{LIMITS_SORT_OTHER} rows ({LIMITS_SORT_INACTIVE} inactive)"
            torch.cuda.empty_cache()
            words, inact = big_sort_inputs(dev, n, nwords, seed=n % 1000 + nwords)
            per_row = plain_bytes_a_row(plain, words, inact)
            with radix_plan.record_pass_kinds() as kinds:
                got = kernel(words, inact)
            torch.cuda.synchronize()
            kinds = kinds[0].tolist()
            torch.cuda.empty_cache()
            largest = largest_digits(words, inact, sched)
            if kinds != [radix_plan.KIND_TRIVIAL if c == n else radix_plan.KIND_SCATTERED
                         for c in largest]:
                raise AssertionError(f"[limits] {name} ({what}): passes {kinds}, largest digits "
                                     f"{largest}")
            big = [c for c, k in zip(largest, kinds) if k == radix_plan.KIND_SCATTERED
                   and c >= LIMITS_SORT_DIGIT]
            if not big:
                raise AssertionError(f"[limits] {name} ({what}): no scattering pass has a digit "
                                     f"of {LIMITS_SORT_DIGIT} rows: {largest}")
            free = torch.cuda.mem_get_info(dev)[0]
            need = 1.1 * per_row * n
            if need < free:
                want = plain(words, inact)
                err = chunked_max_abs_err(got, want)
                del want
                if err:
                    raise AssertionError(f"[limits] {name} ({what}): max abs err {err} against "
                                         f"the plain version")
                checked = "equal to its plain version, max abs err 0"
            else:
                perm, s_act = (got[1], got[2]) if name == "view_sort" else got
                sort_is_defined(f"{name} ({what})", words, inact, perm, s_act,
                                got[0] if name == "view_sort" else None)
                checked = "the stable sort's definition holds (the plain version does not fit)"
            del got
            torch.cuda.empty_cache()
            log(f"[limits] {card}: {name} ({what}): passes {kinds}; largest digits {largest}, "
                f"{big} in scattering passes; plain version's peak {per_row:.1f} B a row, "
                f"{need / 1e9:.1f} GB against {free / 1e9:.1f} GB free: {checked}")
            times[f"{name}_{n}"] = limits_reading(
                f"{name} n={n}", what, lambda w=words, ia=inact, k=kernel: k(w, ia), card,
                launched, (counter,), reps=3, checked=checked)
            del words, inact
    torch.cuda.empty_cache()


def numpy_topk(h: np.ndarray, nact: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """lax.top_k's (hash, count) of the runs of sorted `h[:nact]`: count
    descending, the lower position first, the zero-count positions after."""
    n = h.shape[0]
    pos = np.arange(n)
    start = np.zeros(n, bool)
    if nact:
        start[:nact] = np.concatenate([[True], h[1:nact] != h[:nact - 1]])
    runs = np.flatnonzero(start)
    counts = np.zeros(n, np.int64)
    counts[runs] = np.diff(np.append(runs, nact))
    order = np.lexsort((pos, -counts))[:k]
    return h[order], counts[order].astype(np.int32)


def numpy_hot(gh: np.ndarray, gc: np.ndarray, thr: int) -> np.ndarray:
    """JAX's hot_hash_set reduction by a group-by: a hash's first candidate
    is hot where its candidates' counts sum (int32, wrapping) above thr."""
    uniq, first, inv = np.unique(gh, return_index=True, return_inverse=True)
    tot = np.bincount(inv, weights=gc.astype(np.float64), minlength=len(uniq)).astype(np.int64)
    tot = ((tot + 2**31) % 2**32) - 2**31
    out = np.full(gh.shape[0], 0xFFFFFFFF, np.uint32)
    hot = (tot > thr) & (uniq != 0xFFFFFFFF)
    out[first[hot]] = uniq[hot]
    return out


def lex_bytes(words: list) -> np.ndarray:
    """Rows of u32 words as big-endian byte strings: their order is the
    words' lexicographic unsigned order."""
    mat = np.stack([np.asarray(w, np.uint32) for w in words], 1).astype(">u4")
    return np.ascontiguousarray(mat).view(f"S{4 * len(words)}").reshape(-1)


def phase_limits(dev, card: str) -> dict:
    """Each form the port takes past a kernel's shared-memory limit, on the
    card at a size past the real limit, against its plain version and numpy,
    with its device time and launches: K19 at k = 1025 and 4096 on a Zipf
    shard (K3 and K1 over the runs); K20 with 32 x 1024 candidates a side
    (K1, K2, K7); K21 with a list of 65,536 entries (K1, K15); K22 with
    14,999 splitters of 4 words (two rounds); the shuffle's K9 over 40,000
    cells and value_boundaries over 60,002 probes on one shard's rows
    (rounds); member_multiplicity over a build of 2^30 + 1 rows (two K10
    parts); K1 and K5 past 2^30 rows (limits_big_sorts)."""
    from database_technology_algorithms_tpu_torch.batch import u32_bits
    from database_technology_algorithms_tpu_torch.kernels import cells_plan, hot_set, range_dest
    from database_technology_algorithms_tpu_torch.kernels import stage_cells
    from database_technology_algorithms_tpu_torch.kernels import topk_runs as k19
    from database_technology_algorithms_tpu_torch.ops.hash_join import member_multiplicity
    from database_technology_algorithms_tpu_torch.ops.keys import key_hash
    from database_technology_algorithms_tpu_torch.ops.movement import sort_words
    from database_technology_algorithms_tpu_torch.parallel import shuffle, skew
    from database_technology_algorithms_tpu_torch.parallel.dist_ops import hash_dest

    g = np.random.default_rng(22)
    launched, times = {}, {}
    torch.cuda.empty_cache()
    # a Zipf shard of BASELINE config 4's skew join
    cols = dist_cols(DIST_ROWS // DIST_SHARDS, 81, zipf_a=ZIPF_A)
    shard = to_batch(cols, dev)
    hashes = key_hash(shard, 1)
    active = shard.valid
    (hs,), _ = sort_words([torch.where(active, hashes, hot_set.SENTINEL)])
    nact = active.sum(dtype=torch.int32)
    hs_host, nact_host = u32_host(hs), int(nact)

    # K19 past TOPK_MAX_K
    for k in LIMITS_TOPK:
        got = k19.topk_runs(hs, nact, k)
        assert_same(f"[limits] K19 sort form, k = {k}", got, k19.topk_runs_plain(hs, nact, k))
        wh, wc = numpy_topk(hs_host, nact_host, k)
        if not (np.array_equal(u32_host(got[0]), wh) and np.array_equal(u32_host(got[1]), wc)):
            raise AssertionError(f"[limits] K19 sort form, k = {k}: differs from numpy")
        pub = skew.local_topk_hashes(hashes, active, k)
        assert_same(f"[limits] local_topk_hashes, k = {k}", pub, got)
        times[f"k19_k{k}"] = limits_reading(
            f"topk_runs k={k}", f"{hs.shape[0]} sorted hashes of a Zipf shard, {nact_host} live",
            lambda k=k: k19.topk_runs(hs, nact, k), card, launched,
            ("compact", "radix_sort"), ("topk_runs",))

    # K20 past HOT_MAX_CANDIDATES a side
    m = LIMITS_SHARDS_K20 * 1024
    pool = g.integers(0, 2**32, size=4000, dtype=np.uint64).astype(np.uint32)
    sides = []
    for _ in range(2):
        gh = pool[np.minimum(g.zipf(1.3, m), len(pool)) - 1]
        gh[g.random(m) < 0.05] = 0xFFFFFFFF
        gc = g.integers(1, 3000, size=m).astype(np.int32)
        sides.append((gh, gc, int(g.integers(10**5, 10**6))))
    div = LIMITS_SHARDS_K20 * 4
    args = []
    for gh, gc, tot in sides:
        args += [u32_dev(gh, dev), torch.from_numpy(gc).to(dev),
                 torch.tensor(tot, dtype=torch.int32, device=dev)]
    got_hot, got_n = hot_set.hot_lists(*args, div)
    want_hot, want_n = hot_set.hot_lists_plain(*args, div)
    assert_same("[limits] K20 sort form", (got_hot, got_n), (want_hot, want_n))
    ref = np.concatenate([numpy_hot(gh, gc, max(tot // div, 1)) for gh, gc, tot in sides])
    if not np.array_equal(u32_host(got_hot), ref) or int(got_n) != int((ref != 0xFFFFFFFF).sum()):
        raise AssertionError("[limits] K20 sort form differs from numpy")
    if not int(got_n):
        raise AssertionError("[limits] K20 sort form: no hot hash, so nothing was held")
    del want_hot
    torch.cuda.empty_cache()
    times["k20"] = limits_reading(
        "hot_lists", f"{m} + {m} candidates ({LIMITS_SHARDS_K20} shards x hh_topk 1024), "
        f"{int(got_n)} hot", lambda: hot_set.hot_lists(*args, div), card, launched,
        ("radix_sort", "seg_scan", "unpermute"), ("hot_hashes",))

    # K21 past IN_SET_MAX_HOT
    hot = np.full(LIMITS_HOT, 0xFFFFFFFF, np.uint32)
    live = g.choice(LIMITS_HOT, LIMITS_HOT // 3, replace=False)
    hot[live] = g.integers(0, 2**32, size=live.shape[0], dtype=np.uint64).astype(np.uint32)
    hh_host = u32_host(hashes)
    hot[live[:500]] = g.choice(hh_host, 500)
    hot_d = u32_dev(hot, dev)
    got = hot_set.in_hot_set(hashes, hot_d)
    assert_same("[limits] K21 sort form", (got,), (hot_set.in_hot_set_plain(hashes, hot_d),))
    want = np.isin(hh_host, hot[hot != 0xFFFFFFFF])
    if not np.array_equal(got.cpu().numpy(), want) or not want.any():
        raise AssertionError("[limits] K21 sort form differs from numpy")
    times["k21"] = limits_reading(
        "in_hot_set", f"{hashes.shape[0]} row hashes, a list of {LIMITS_HOT} "
        f"({live.shape[0]} live)", lambda: hot_set.in_hot_set(hashes, hot_d), card, launched,
        ("radix_sort", "sorted_probe"), ("in_hot_set",))

    # K22 past its splitter bytes
    nr, nw = LIMITS_K22_ROWS, 4
    kw = [g.integers(0, 2**32, size=nr, dtype=np.uint64).astype(np.uint32) for _ in range(nw)]
    kw[0] = g.integers(0, 50, size=nr).astype(np.uint32)  # ties on the leading words
    spl = [g.integers(0, 2**32, size=LIMITS_SPLITTERS, dtype=np.uint64).astype(np.uint32)
           for _ in range(nw)]
    spl[0] = g.integers(0, 50, size=LIMITS_SPLITTERS).astype(np.uint32)
    order = np.lexsort(spl[::-1])
    spl = [s_[order] for s_ in spl]
    words_d, spl_d = [u32_dev(w, dev) for w in kw], [u32_dev(s_, dev) for s_ in spl]
    got = range_dest.range_dest(words_d, spl_d)
    assert_same("[limits] K22 in rounds", (got,), (range_dest.range_dest_plain(words_d, spl_d),))
    want = np.searchsorted(lex_bytes(spl), lex_bytes(kw), side="right")
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("[limits] K22 in rounds differs from numpy")
    torch.cuda.empty_cache()
    times["k22"] = limits_reading(
        "range_dest", f"{nr} keys of {nw} words, {LIMITS_SPLITTERS} splitters in rounds of "
        f"{range_dest.dist_plan.range_round(nw, LIMITS_SPLITTERS)}",
        lambda: range_dest.range_dest(words_d, spl_d), card, launched, ("range_dest",))
    if launched["range_dest"]["range_dest"] < 2:
        raise AssertionError("[limits] K22 took one round past its splitter bytes")

    # the shuffle's K9 over 40,000 cells and value_boundaries over 60,002 probes
    cnt = active.sum(dtype=torch.int32)
    dest = hash_dest(shard, 1, LIMITS_CELLS)
    words = shard.payload_words()
    got = stage_cells.stage_to_cells(dest, None, LIMITS_CELLS, LIMITS_CELL_CAP, words,
                                     row_map="none", count=cnt)
    want = stage_cells.stage_to_cells_plain(dest, None, LIMITS_CELLS, LIMITS_CELL_CAP, words,
                                            row_map="none", count=cnt)
    assert_same("[limits] K9 cells in rounds", (*got[0], got[1], got[3]),
                (*want[0], want[1], want[3]))
    per_cell = np.bincount(u32_host(dest)[:int(cnt)], minlength=LIMITS_CELLS)
    if not (np.array_equal(got[1].cpu().numpy(), np.minimum(per_cell, LIMITS_CELL_CAP))
            and int(got[3]) == int(np.maximum(per_cell - LIMITS_CELL_CAP, 0).sum())):
        raise AssertionError("[limits] K9 cells in rounds: counts or overflow differ from numpy")
    pub = shuffle.partition_to_slots(shard, cnt, dest, LIMITS_CELLS, LIMITS_CELL_CAP)
    assert_same("[limits] partition_to_slots in rounds", (pub[2], pub[3]), (got[1], got[3]))
    del want, pub
    times["k9_cells"] = limits_reading(
        "stage_to_cells", f"{shard.nrows} rows ({int(cnt)} live) into {LIMITS_CELLS} cells of "
        f"{LIMITS_CELL_CAP}, {len(words)} words, rounds of "
        f"{cells_plan.stage_width(shard.nrows, LIMITS_CELLS)}",
        lambda: stage_cells.stage_to_cells(dest, None, LIMITS_CELLS, LIMITS_CELL_CAP, words,
                                           row_map="none", count=cnt),
        card, launched, ("stage_cells",))
    dest2 = hash_dest(shard, 1, LIMITS_PROBE_SHARDS)
    nprobes = LIMITS_PROBE_SHARDS + 2
    got = stage_cells.value_boundaries(dest2, nprobes)
    assert_same("[limits] value_boundaries in rounds", (got,),
                (stage_cells.value_boundaries_plain(dest2, nprobes),))
    hist = np.bincount(np.minimum(u32_host(dest2), nprobes), minlength=nprobes + 1)[:nprobes]
    if not np.array_equal(got.cpu().numpy(), np.cumsum(hist) - hist):
        raise AssertionError("[limits] value_boundaries in rounds differs from numpy")
    counts, rank = shuffle._dest_ranks(dest2, LIMITS_PROBE_SHARDS)
    d_host = u32_host(dest2)
    order = np.argsort(d_host, kind="stable")
    want_rank = np.empty_like(order)
    want_rank[order] = np.arange(d_host.shape[0]) - (np.cumsum(hist) - hist)[d_host[order]]
    if not (np.array_equal(counts.cpu().numpy(), hist[:LIMITS_PROBE_SHARDS + 1])
            and np.array_equal(rank.cpu().numpy(), want_rank)):
        raise AssertionError("[limits] _dest_ranks over 60,000 shards differs from numpy")
    times["k9_probes"] = limits_reading(
        "value_boundaries", f"{dest2.shape[0]} rows, {nprobes} probes in rounds of "
        f"{cells_plan.boundary_width(dest2.shape[0], nprobes)}",
        lambda: stage_cells.value_boundaries(dest2, nprobes), card, launched, ("stage_cells",))
    del shard, hashes, hs, got, dest, dest2, words, counts, rank
    torch.cuda.empty_cache()

    # K10 past MAX_TABLE_BUILD: the parts on the card at a shrunk limit against
    # the unsplit plain version, then 2^30 + 1 build rows against numpy
    small = torch.from_numpy(g.integers(0, 500, size=3001).astype(np.int32)).to(dev)
    q = torch.from_numpy(g.integers(0, 600, size=5000).astype(np.int32)).to(dev)
    lk = torch.from_numpy(g.random(5000) < 0.9).to(dev)
    want = member_multiplicity([small], 2900, [q], lk)
    saved = cells_plan.MAX_TABLE_BUILD
    cells_plan.MAX_TABLE_BUILD = 1000
    try:
        got = member_multiplicity([small], 2900, [q], lk)
    finally:
        cells_plan.MAX_TABLE_BUILD = saved
    assert_same("[limits] K10 in parts (limit 1000)", (got,), (want,))
    from database_technology_algorithms_tpu_torch.kernels.member_mult import (
        member_multiplicity_cells_plain)
    assert_same("[limits] K10 in parts against the plain version", (got,),
                (member_multiplicity_cells_plain([small[None]], torch.tensor(
                    [2900], dtype=torch.int32, device=dev), [q[None]], None, lk[None])[0],))
    n, mul = LIMITS_BUILD, 0x9E3779B1
    period = (n - 1) // 2
    # (i mod period) * mul mod 2^32, an odd multiplier: every key twice, key 0 three times
    build = (torch.arange(n, dtype=torch.int32, device=dev) % period) * (mul - (1 << 32))
    jq = np.concatenate([[0, period - 1, 1], g.integers(0, 2 * period, LIMITS_QUERY - 3)])
    qd = u32_bits(torch.from_numpy(jq).to(dev) * mul)
    live_q = torch.ones(LIMITS_QUERY, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = member_multiplicity([build], n, [qd], live_q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = np.where(jq == 0, 3, np.where(jq < period, 2, 0))
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError(f"[limits] member_multiplicity over {n} build rows differs from "
                             f"numpy")
    times["k10"] = limits_reading(
        "member_multiplicity", f"{n} build rows (every key twice, one three times, across the "
        f"parts), {LIMITS_QUERY} query rows, parts of {cells_plan.table_part(n)}",
        lambda: member_multiplicity([build], n, [qd], live_q), card, launched,
        ("member_mult",), reps=1)
    if launched["member_multiplicity"]["member_mult"] != 2:
        raise AssertionError("[limits] K10 did not take two parts past MAX_TABLE_BUILD")
    log(f"[limits] {card}: member_multiplicity over {n} build rows: first call {wall:.2f} s "
        f"of host wall")
    del build, qd, got
    torch.cuda.empty_cache()
    limits_big_sorts(dev, card, launched, times)
    return {"times": times, "launched": launched}


def phase_timings(pipe: dict, command: dict, over: dict, sort: dict, probes: dict, errs: dict,
                  card: str) -> list[dict]:
    from database_technology_algorithms_tpu_torch.batch import RecordBatch, as_u32
    from database_technology_algorithms_tpu_torch.kernels import radix_plan
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
    # stage A's run heads, a bool column as the main path scans it (and its
    # int32 copy, the form K2 took before it read bools)
    r_first_b = (perm < nr) & ~inact[perm.long()] & is_start
    r_first = r_first_b.to(torch.int32)
    front_cnt, (orig_front,) = compact_words(matched, (perm,))
    cnt = int(front_cnt)
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
             kernel=lambda: seg_scan(is_start, r_first_b, "add"),
             plain=lambda: seg_scan_plain(is_start, r_first_b, "add"),
             library=lambda: torch.cumsum(r_first_b, 0, dtype=torch.int32),
             nbytes=n * (1 + 1) + n * 4,
             shape=f"{n} rows, segmented add of bool values (stage A's run-head carry)"),
        dict(name="compact", source=f"{PKG}/csrc/compact.cu",
             replaces=f"{JAX_PKG}/ops/movement.py:479",
             kernel=lambda: compact_words(matched, (perm,)),
             plain=lambda: compact_words_plain(matched, (perm,)),
             library=lambda: torch.masked_select(perm, matched),
             nbytes=n * (1 + 4) + n * 4 + 4,
             shape=f"{n} rows, 1 payload word (perm); its counts and moves"),
        dict(name="take_fill", source=f"{PKG}/csrc/take_fill.cu",
             replaces=f"{JAX_PKG}/batch.py:220",
             # as materialize_survivors calls it: the live count on the card
             kernel=lambda: take_fill(*rcols, orig_front[:nr], front_cnt),
             plain=lambda: take_fill_plain(*rcols, orig_front[:nr], front_cnt),
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
        "reversed segmented max of bools (any-S suffix)": lambda: seg_scan(
            is_start, r_first_b, "max", reverse=True),
        "plain add scan of bools (cumsum)": lambda: seg_scan(None, r_first_b, "add"),
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
    recs = {rec["name"]: rec for rec in out}
    # K2 on int32 values, the form earlier readings took; K2 and K3 beyond L2
    recs["seg_scan"].update({
        "ms_int32_values": device_ms(lambda: seg_scan(is_start, r_first, "add")),
        "library_ms_int32_values": device_ms(lambda: torch.cumsum(r_first, 0, dtype=torch.int32)),
        "bound_ms_int32_values": bound_ms(n * (1 + 4) + n * 4)})
    big = GATHER_CHUNK
    b_flags = torch.rand(big, device=key.device,
                         generator=torch.Generator(device=key.device).manual_seed(12)) < 0.3
    b_vals = torch.randint(-2**31, 2**31, (big,), dtype=torch.int32, device=key.device,
                           generator=torch.Generator(device=key.device).manual_seed(13))
    recs["seg_scan"].update({
        "ms_16M": device_ms(lambda: seg_scan(b_flags, b_vals)),
        "plain_ms_16M": device_ms(lambda: seg_scan_plain(b_flags, b_vals)),
        "library_ms_16M": device_ms(lambda: torch.cumsum(b_vals, 0, dtype=torch.int32)),
        "bound_ms_16M": bound_ms(big * (1 + 4) + big * 4)})
    rec2 = recs["seg_scan"]
    log(f"[timing] {card}: seg_scan at {n} rows on int32 values: kernel "
        f"{rec2['ms_int32_values']:.4f} ms, library torch.cumsum "
        f"{rec2['library_ms_int32_values']:.4f} ms, bound {rec2['bound_ms_int32_values']:.4f} ms; "
        f"at {big} rows (segmented add, int32 values, beyond L2): kernel {rec2['ms_16M']:.4f} ms, "
        f"plain {rec2['plain_ms_16M']:.4f} ms, library torch.cumsum {rec2['library_ms_16M']:.4f} "
        f"ms, bound {rec2['bound_ms_16M']:.4f} ms ({big * 9} B)")
    del b_flags, b_vals
    recs["compact"]["shapes"] = [over["k3_chunk"]]
    # K6 at the over-budget route's largest calls and within the command's
    # profile; K7's scatter in its bool form on the placement route
    recs["adj_equal"]["shapes"] = over["k6_chunk"]
    recs["unpermute"]["shapes"] = [scatter_timing(
        sort["k7_bool"], card, "the 'sort' route, field 1, stage B's packed_keep_backsort")]
    for name in ("adj_equal", "unpermute"):
        recs[name]["command_profile_us"] = {
            f"field {f}": us[name] for f, us in command["k67_us"].items()}
    # K4 at the pipeline command's four shapes (field 2) and the over-budget
    # route's largest chunk
    stages = ("distinct R", "distinct S", "join_sorted_distinct", "hash_join's rows")
    recs["take_fill"]["shapes"] = [
        take_fill_timing(call, card, f"pipeline command field 2, {stage}")
        for stage, call in zip(stages, command["k4_calls"])] + [over["k4_chunk"]]
    for what, fn in ((f"K1 at {n} rows", lambda: view_sort(inact, key)),
                     (f"K5 at {dn} rows", lambda: words_sort(d_words, d_inact)),
                     (f"K2 at {n} rows", lambda: seg_scan(is_start, r_first_b, "add")),
                     (f"K3 at {n} rows", lambda: compact_words(matched, (perm,)))):
        log(f"[timing] {card}: {what}, device ms a call by kernel: "
            f"{device_parts(profile_device(fn, reps=10), top=5)}")
    # the passes of the timed K1 and K5 calls that scattered and that were
    # trivial (skipped), as the kernel chose them on the card
    recs["radix_sort"]["passes"] = pass_kinds(
        "K1", f"{n} rows", lambda: view_sort(inact, key), [key], inact,
        radix_plan.view_sort_schedule())
    recs["words_sort"]["passes"] = pass_kinds(
        "K5", f"{dn} rows, {dk} words", lambda: words_sort(d_words, d_inact), d_words, d_inact,
        radix_plan.words_sort_schedule(dk, True))
    # K1 at the budget edge, beyond L2: the keys of an 8M + 8M staged run
    big = 2 * BIG_ROWS
    b_key = torch.randint(0, 3 * BIG_ROWS // 10, (big,), dtype=torch.int32, device=key.device,
                          generator=torch.Generator(device=key.device).manual_seed(9))
    b_inact = torch.zeros(big, dtype=torch.bool, device=key.device)
    b_comp = as_u32(b_key)
    recs["radix_sort"].update({
        "ms_16M": device_ms(lambda: view_sort(b_inact, b_key)),
        "library_ms_16M": device_ms(lambda: torch.sort(b_comp, stable=True)),
        "bound_ms_16M": bound_ms(big * (4 + 1) + big * (4 + 4 + 1)),
        "passes_16M": pass_kinds("K1", f"{big} rows", lambda: view_sort(b_inact, b_key),
                                 [b_key], b_inact, radix_plan.view_sort_schedule()),
    })
    log(f"[timing] {card}: radix_sort ({big} rows, the 8M + 8M staged run's keys, beyond L2): "
        f"device time per call: kernel {recs['radix_sort']['ms_16M']:.4f} ms, library stable "
        f"torch.sort {recs['radix_sort']['library_ms_16M']:.4f} ms, bound "
        f"{recs['radix_sort']['bound_ms_16M']:.4f} ms ({big * 14} B); by kernel: "
        f"{device_parts(profile_device(lambda: view_sort(b_inact, b_key), reps=10), top=5)}")
    del b_key, b_inact, b_comp
    # K8-K10 were timed at the over-budget run's shapes while its tables were
    # on the card; their launches are that run's
    for rec in over["recs"]:
        out.append({**rec, "max_abs_err": max(rec["max_abs_err"], errs[rec["name"]])})
    out += probe_records(sort, probes, errs, card)
    return out


def pass_kinds(kernel: str, shape: str, fn, words, inact, sched) -> dict:
    """One call of fn with the pass kinds recorded: how many passes the kernel
    scattered and how many were trivial and skipped, checked against the rule of
    kernels/radix_plan.py applied to the same inputs."""
    from database_technology_algorithms_tpu_torch.kernels import radix_plan

    with radix_plan.record_pass_kinds() as kinds:
        fn()
    torch.cuda.synchronize()
    got = kinds[0].tolist()
    want = [radix_plan.KIND_TRIVIAL if t else radix_plan.KIND_SCATTERED
            for t in radix_plan.trivial_passes(words, inact, sched)]
    if got != want:
        raise AssertionError(f"{kernel} {shape}: pass kinds {got}, expected {want}")
    res = {"scattered": got.count(radix_plan.KIND_SCATTERED),
           "trivial": got.count(radix_plan.KIND_TRIVIAL)}
    log(f"[passes] {kernel} {shape}: {res['scattered']} passes scattered, {res['trivial']} "
        f"trivial and skipped (kinds by pass, least significant first: {got})")
    return res


def probe_records(sort: dict, probes: dict, errs: dict, card: str) -> list[dict]:
    """K11 at the probe's shapes (its launches: one probe run for each G) and
    K12 at the "sort2d" route's shape, stage B of the staged pipeline, field
    1 at 1M + 1M (its launches: one run of that route), with the probe's P4
    and P5 readings beside."""
    from database_technology_algorithms_tpu_torch.kernels.radix_sort import view_sort
    from database_technology_algorithms_tpu_torch.kernels.row_move import (
        row_move, row_move_plain)
    from database_technology_algorithms_tpu_torch.kernels.tile_copy import tile_copy_plain
    from database_technology_algorithms_tpu_torch.tools import bench_pallas_dma as dma

    k11 = probes["k11"]
    r, a2d = sort["inputs_2d"]
    pin = probe_inputs(r.recid.device, np.random.default_rng(7))
    rec11 = {
        "name": "tile_copy", "route": "cuda",
        "source": f"{PKG}/csrc/tile_copy.cu", "replaces": "tools/bench_pallas_dma.py:43",
        "launches": probes["launches"]["tile_copy"], "max_abs_err": errs["tile_copy"],
        "ms": k11[32]["ms"],
        "plain_ms": device_ms(lambda: tile_copy_plain(pin["x"], pin["starts"]["identity"], 32)),
        "bound_ms": k11[32]["bound_ms"], "bound_by": "bytes", "library_ms": k11[32]["library_ms"],
        "shape": f"n={dma.N} rows x {dma.W} words, T={dma.T}, G=32 (ms_by_G: every G)",
        "ms_by_G": {str(G): r["ms"] for G, r in k11.items()},
        "ms_alternating": probes["k11_alternating"]["ms"],
        "library_ms_alternating": probes["k11_alternating"]["library_ms"],
    }
    del pin
    dest, cnt = a2d["dest"], a2d["cnt"]
    n = dest.shape[0]
    words = torch.stack(r.payload_words(), dim=1)
    perm = view_sort(torch.zeros(n, dtype=torch.bool, device=dest.device), dest)[1]
    slot = torch.where(torch.arange(n, dtype=torch.int32, device=dest.device) < cnt, perm, n)
    clamped = slot.clamp(max=n - 1)
    w, live = words.shape[1], int(cnt)
    nbytes = n * 4 + live * w * 4 + n * w * 4  # slots; live source rows; every output row
    rec12 = {
        "name": "row_move", "route": "cuda",
        "source": f"{PKG}/csrc/row_move.cu", "replaces": "tools/bench_permute_prims.py:155",
        "launches": sort["launches"][("sort2d", 1)]["row_move"], "max_abs_err": errs["row_move"],
        # as the route's _place calls it: the rank order and the live count
        "ms": device_ms(lambda: row_move(words, perm, n, True, cnt)),
        "plain_ms": device_ms(lambda: row_move_plain(words, perm, n, True, cnt)),
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": device_ms(lambda: torch.index_select(words, 0, clamped)),
        "shape": f"{n} rows x {w} words, one tile, {live} live (sort2d stage B, field 1)",
        "probe": probes["k12"],
    }
    log(f"[timing] {card}: row_move ({rec12['shape']}): device time per call: kernel "
        f"{rec12['ms']:.4f} ms, plain {rec12['plain_ms']:.4f} ms, library index_select (no fill) "
        f"{rec12['library_ms']:.4f} ms, bound {rec12['bound_ms']:.4f} ms ({nbytes} B); "
        f"tile_copy at G=32: kernel {rec11['ms']:.4f} ms, plain {rec11['plain_ms']:.4f} ms")
    return [rec11, rec12]


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
    phase_utils(dev, card, pipe)
    done("utils")
    sort = phase_sort_route(dev, card, pipe)
    done("sort route")
    probes = phase_probes(dev, card, np.random.default_rng(8))
    done("probes")
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
    for name, err in phase_external(dev, card).items():
        errs[name] = max(errs[name], err)
    done("external")
    agg = phase_aggregate(dev, card)
    done("aggregate")
    eng = phase_engines(dev, card)
    done("engines")
    dist = phase_dist(dev, card)
    done("dist")
    phase_multiproc(dev, card)
    done("multiproc")
    phase_limits(dev, card)
    done("limits")
    kernels = (phase_timings(pipe, command, over, sort, probes, errs, card) + agg["recs"]
               + eng["recs"] + dist["recs"])
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
