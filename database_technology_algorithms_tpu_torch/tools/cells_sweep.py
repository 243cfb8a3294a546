"""K9's span and place warps and K10's shared table swept on the card.

K9 (``csrc/stage_cells.cu``) is timed phase by phase (count, the matrix's
scan, finish, place, dead fill) at the over-budget run's probe side: 24M
rows, 6.94M of them live (the distinct keys of 24M draws from 7.2M values),
into 4096 cells of 8792 slots with one key word, for spans of 4K-16K rows a
block and 4 or 8 warps a place block, in the live-count form with the "si"
and "none" row maps and in the mask form; then at the plan's span and warps,
built without the place pass's L2 keep hints.  K10 (``csrc/member_mult.cu``)
is timed on one step of that run, 512 pairs of 8792 + 8792 slots with
1600-1800 live rows a side, and with two thirds of every side live, for
shared tables of 4096-16384 slots (pairs that need more take the global
table) and 256, 512 or 1024 threads a block.  A time is a named kernel's
mean device time over 20 calls (torch.profiler), in ms;
inputs are random, made on the card from a seed.  ``kernels/cells_plan.py``'s
SPAN, PLACE_WARPS, TABLE_BYTES and TABLE_THREADS are the ones these readings
chose.

    python -m database_technology_algorithms_tpu_torch.tools.cells_sweep
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import shutil
import subprocess

import torch

from ..kernels import _lib, cells_plan
from ..kernels.member_mult import member_multiplicity_cells
from ..kernels.stage_cells import stage_to_cells
from . import device_name

ROWS, CELLS, CAP = 24_000_000, 4096, 8792  # ops/hash_join._tile_layout(24M, 24M, 16M)
LIVE = int(7_200_000 * (1 - math.exp(-ROWS / 7_200_000)))
SPANS = (4096, 8192, 16384)
WARPS = (4, 8)
TABLE_SLOTS = (4096, 8192, 16384)
TABLE_THREADS = (256, 512, 1024)
# a copy of stage_cells.cu built without the place pass's L2 keep hints
# (plain stores for si and the cells): what the hints buy
NO_KEEP = "-DST_KEEP_WRITES=0"
PHASES = ("cells_count", "seg_scan_kernel", "cells_finish", "cells_fill_dead", "cells_place")
REPS = 20


@contextlib.contextmanager
def plan(**values):
    """cells_plan's constants set to `values` for the block's calls."""
    old = {k: getattr(cells_plan, k) for k in values}
    for k, v in values.items():
        setattr(cells_plan, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(cells_plan, k, v)


def build_no_keep() -> ctypes.CDLL:
    """stage_cells.cu built with NO_KEEP under build/cells_sweep/."""
    d = _lib.BUILD_DIR.parent / "cells_sweep"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    out = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, NO_KEEP, "-shared",
                          str(_lib.CSRC / "stage_cells.cu"), "-o", str(d / "lib.so")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"cells_sweep: nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = lib.dbt_stage_cells
    fn.argtypes, fn.restype = _lib._SIGNATURES["dbt_stage_cells"]
    return lib


@contextlib.contextmanager
def library(lib):
    """The wrappers' _lib.library() returning `lib` for the block's calls."""
    old = _lib.library
    _lib.library = lambda: lib
    try:
        yield
    finally:
        _lib.library = old


def phase_ms(fn, names: tuple) -> dict:
    """{name: mean device time of the kernel whose name holds it, in ms},
    over REPS calls, each of which launches every named kernel once; the
    mean is over the launches the trace kept (a trace may lose events at
    its start)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            for name in names:
                if name in ev.name:
                    by_name.setdefault(name, []).append(ev.device_time)
    missing = set(names) - set(by_name)
    if missing:
        raise RuntimeError(f"cells_sweep: torch.profiler saw no {sorted(missing)}")
    return {k: sum(v) / len(v) / 1e3 for k, v in by_name.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("cells_sweep: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[cells_sweep] {smi or device_name(dev)}")
    gen = torch.Generator(device=dev).manual_seed(31)
    dest = torch.randint(0, CELLS, (ROWS,), dtype=torch.int32, device=dev, generator=gen)
    word = torch.randint(-2**31, 2**31 - 1, (ROWS,), dtype=torch.int32, device=dev, generator=gen)
    live = torch.tensor(LIVE, dtype=torch.int32, device=dev)
    mask = torch.arange(ROWS, device=dev) < live
    forms = {
        "count, si": lambda: stage_to_cells(dest, None, CELLS, CAP, [word], "si", live,
                                            in_range=True),
        "count, none": lambda: stage_to_cells(dest, None, CELLS, CAP, [word], "none", live,
                                              in_range=True),
        "mask, si": lambda: stage_to_cells(dest, mask, CELLS, CAP, [word], "si", in_range=True),
    }
    for span in SPANS:
        for warps in WARPS:
            with plan(SPAN=span, PLACE_WARPS=warps):
                for form, fn in forms.items():
                    t = phase_ms(fn, PHASES)
                    print(f"[cells_sweep] K9 {ROWS} rows ({LIVE} live), {form}, span {span}, "
                          f"{warps} warps: all {sum(t.values()):.4f} ms; "
                          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    with library(build_no_keep()):
        for form, fn in forms.items():
            t = phase_ms(fn, PHASES)
            print(f"[cells_sweep] K9 {ROWS} rows, {form}, span {cells_plan.SPAN}, "
                  f"{cells_plan.PLACE_WARPS} warps, without the L2 keep hints: all "
                  f"{sum(t.values()):.4f} ms; " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()),
                  flush=True)
    del dest, word, mask

    g = 512
    bkeys = torch.randint(-2**31, 2**31 - 1, (g, CAP), dtype=torch.int32, device=dev,
                          generator=gen)
    kkeys = torch.randint(-2**31, 2**31 - 1, (g, CAP), dtype=torch.int32, device=dev,
                          generator=gen)
    kkeys[:, ::2] = bkeys[:, ::2]  # half the query slots hold a build key
    nb = torch.randint(1600, 1801, (g,), dtype=torch.int32, device=dev, generator=gen)
    nk = torch.randint(1600, 1801, (g,), dtype=torch.int32, device=dev, generator=gen)
    full = torch.full((g,), CAP * 2 // 3, dtype=torch.int32, device=dev)
    for slots in TABLE_SLOTS:
        for threads in TABLE_THREADS:
            with plan(TABLE_BYTES=slots * 8, TABLE_THREADS=threads):
                step = phase_ms(lambda: member_multiplicity_cells([bkeys], nb, [kkeys], nk),
                                ("member_mult_kernel",))
                dense = phase_ms(lambda: member_multiplicity_cells([bkeys], full, [kkeys], full),
                                 ("member_mult_kernel",))
            print(f"[cells_sweep] K10 {g} pairs of {CAP} + {CAP}, shared table {slots} slots, "
                  f"{threads} threads: 1600-1800 live a side "
                  f"{step['member_mult_kernel']:.4f} ms, {CAP * 2 // 3} live "
                  f"{dense['member_mult_kernel']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
