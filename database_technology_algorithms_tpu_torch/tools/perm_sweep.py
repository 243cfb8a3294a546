"""K6 (adjacent-key equality) and K7 (un-permute, scatter and gather) swept
on the card, through their C entries, at the main paths' shapes.

- K6 by rows a lane (R = 1, 2, 4, 8) with the plan's stages, and at the
  plan's R with other stages (4 words of the key wherever they lie, a word
  a stage), on the ``pipeline`` command's R || S (two tables from the
  generator) at 2M rows (``--nblocks 10000``) and 16M: field 2's and field
  3's keys through their sort order (K5's perm), and in place on sorted
  rows (field 2's, and field 1's one contiguous word).
- K7's scatter, the package's one row a thread, against forms of R rows
  a thread (SCATTER_SOURCE below: 16-byte loads of perm and the values
  before any store) in grids of one and two waves of the blocks the card
  holds and of one block a 256 R rows (``perm_plan.blocks``), at 2M sorted
  rows to the 1M probe rows' int32 answers and bool flags, twice in turns.
- K7's gather by rows a thread and grid at the over-budget route's probe
  side (24M rows, 6.94M live, 4096 cells of 8792 slots, one key word),
  against the scatter through the staging permutation it replaced and
  against ``index_select`` of the precomputed places; and K9 in the
  ``"slots"`` and ``"si"`` forms that feed them.

Each R other than the plan's runs from a copy of its source built under
``build/perm_sweep/`` with that R, and the scatter's R-row forms from
SCATTER_SOURCE (all ``nvcc`` processes started together).  A time is the
median device time of the named kernels over 20 calls (torch.profiler), in
ms; inputs are random, made on the card from a seed.
``kernels/perm_plan.py``'s ADJ_ROWS and GATHER_ROWS, and the scatter's one
row a thread, are what these readings chose.

    python -m database_technology_algorithms_tpu_torch.tools.perm_sweep [k6] [scatter] [gather]
"""

from __future__ import annotations

import ctypes
import math
import shutil
import statistics
import subprocess
import sys

import torch

from ..batch import RecordBatch, as_u32
from ..io.generator import generate_columns
from ..kernels import _lib, perm_plan
from ..kernels.adj_equal import adj_equal
from ..kernels.stage_cells import stage_to_cells
from ..kernels.unpermute import unpermute, unpermute_gather
from ..kernels.words_sort import words_sort
from ..ops.keys import key_words
from . import device_name

REPS = 20
ADJ_SIZES = (2_000_000, 16_000_000)  # R || S of --nblocks 10000 and 80000
OVER_ROWS, CELLS, CAP = 24_000_000, 4096, 8792  # ops/hash_join._tile_layout(24M, 24M, 16M)
LIVE = int(7_200_000 * (1 - math.exp(-OVER_ROWS / 7_200_000)))


def kernel_ms(fn, names: tuple | None, attempts: int = 3) -> float:
    """Median device time of one call's kernels whose names hold one of
    `names` (None: every kernel of the call), over REPS calls.  A trace may
    lose a few events at its start; one that lost more (a name seen more
    than two times off a multiple of REPS) is taken again, up to `attempts`
    traces; then the reading is refused."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                for name in names or (ev.name,):
                    if name in ev.name:
                        by_name.setdefault(name, []).append(ev.device_time)
        # a kernel launched k times a call shows k * REPS times, less the
        # few events a trace can lose at its start
        per_call = {k: round(len(v) / REPS) for k, v in by_name.items()}
        if (by_name and all(c and abs(len(by_name[k]) - c * REPS) <= 2 for k, c in per_call.items())
                and (names is None or set(by_name) == set(names))):
            return sum(statistics.median(v) * per_call[k] for k, v in by_name.items()) / 1e3
    seen = sorted((k, len(v)) for k, v in by_name.items())
    raise RuntimeError(f"perm_sweep: torch.profiler saw {seen}, not {names} a whole number of "
                       f"times in each of {REPS} calls, in {attempts} traces")


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"perm_sweep: {what} launch failed ({err})")


# K7's scatter with R rows a thread, which the package does not keep: a
# thread loads its rows' perm entries and values (16-byte vectors where
# `vec`) before it stores any, in a grid of `blocks` that walk the rows
SCATTER_SOURCE = r"""
#include "common.cuh"

namespace {

template <class T, int R>
__global__ void __launch_bounds__(256)
    sweep_scatter_kernel(const int32_t* perm, const T* vals, int64_t n, int64_t lo, int64_t m,
                         T* out, int vec) {
  constexpr int PER = 16 / sizeof(T);  // values in a 16-byte vector
  const int64_t stride = (int64_t)gridDim.x * 256 * R;
  for (int64_t i0 = ((int64_t)blockIdx.x * 256 + threadIdx.x) * R; i0 < n; i0 += stride) {
    int32_t p[R];
    T v[R];
    if (vec && i0 + R <= n) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(perm + i0) + q);
        p[4 * q] = x.x;
        p[4 * q + 1] = x.y;
        p[4 * q + 2] = x.z;
        p[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < R / PER; ++q) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(vals + i0) + q);
        const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int k = 0; k < PER; ++k) v[q * PER + k] = e[k];
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = i0 + r < n ? perm[i0 + r] : -1;  // -1: below any window
        v[r] = i0 + r < n ? vals[i0 + r] : T(0);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t d = (int64_t)p[r] - lo;
      if (d >= 0 && d < m) out[d] = v[r];
    }
  }
}

template <class T, int R>
void launch(const void* perm, const void* vals, int64_t n, int64_t lo, int64_t m, void* out,
            int vec, int blocks, cudaStream_t st) {
  sweep_scatter_kernel<T, R><<<blocks, 256, 0, st>>>(
      static_cast<const int32_t*>(perm), static_cast<const T*>(vals), n, lo, m,
      static_cast<T*>(out), vec);
}

}  // namespace

DBT_API int sweep_scatter(const void* perm, const void* vals, int64_t n, int64_t lo, int64_t m,
                          void* out, int elem_bytes, int rows, int vec, int blocks,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4 && rows == 4) launch<uint32_t, 4>(perm, vals, n, lo, m, out, vec, blocks, st);
  else if (elem_bytes == 4 && rows == 8) launch<uint32_t, 8>(perm, vals, n, lo, m, out, vec, blocks, st);
  else if (elem_bytes == 4 && rows == 16) launch<uint32_t, 16>(perm, vals, n, lo, m, out, vec, blocks, st);
  else if (elem_bytes == 1 && rows == 16) launch<uint8_t, 16>(perm, vals, n, lo, m, out, vec, blocks, st);
  else if (elem_bytes == 1 && rows == 32) launch<uint8_t, 32>(perm, vals, n, lo, m, out, vec, blocks, st);
  else return (int)cudaErrorInvalidValue;
  DBT_CHECK_LAUNCH();
  return 0;
}
"""
SCATTER_ROWS = {4: (1, 4, 8, 16), 1: (1, 16, 32)}  # 1: the package's kernel

# copies of the sources built with other R (csrc/adj_equal.cu: ADJ_R;
# csrc/unpermute.cu: UP_GATHER_R), one library each, and SCATTER_SOURCE;
# the plan's own R run from the package's library
BUILT = {"ADJ_R": perm_plan.ADJ_ROWS, "UP_GATHER_R": perm_plan.GATHER_ROWS}
VARIANTS = (
    [("adj_equal.cu", {"ADJ_R": r}) for r in perm_plan.ADJ_ROW_CHOICES if r != perm_plan.ADJ_ROWS]
    + [("unpermute.cu", {"UP_GATHER_R": r}) for r in perm_plan.GATHER_ROW_CHOICES
       if r != perm_plan.GATHER_ROWS]
    + [("sweep_scatter.cu", {"SCATTER": 1})])
ENTRIES = {"adj_equal.cu": ("dbt_adj_equal",), "unpermute.cu": ("dbt_unpermute_gather",),
           "sweep_scatter.cu": ("sweep_scatter",)}
_SWEEP_SIGNATURES = {"sweep_scatter": (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    ctypes.c_int)}


def build_variants() -> list:
    """[(macros, library)] of VARIANTS, built under ``build/perm_sweep/``,
    every ``nvcc`` started together."""
    root = _lib.BUILD_DIR.parent / "perm_sweep"
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for i, (source, macros) in enumerate(VARIANTS):
        d = root / str(i)
        d.mkdir(parents=True)
        shutil.copy(_lib.CSRC / "common.cuh", d / "common.cuh")
        if source == "sweep_scatter.cu":
            (d / source).write_text(SCATTER_SOURCE)
        else:
            shutil.copy(_lib.CSRC / source, d / source)
        flags = [f"-D{k}={v}" for k, v in macros.items()]
        procs.append((source, macros, d, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, *flags, "-shared", str(d / source), "-o",
             str(d / "lib.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for source, macros, d, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"perm_sweep: nvcc failed for {source} {macros}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for name in ENTRIES[source]:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = {**_lib._SIGNATURES, **_SWEEP_SIGNATURES}[name]
        libs.append((macros, lib))
    return libs


def lib_for(libs: list, macro: str, value: int):
    """The library whose `macro` is `value`: the package's for the plan's."""
    if BUILT.get(macro) == value:
        return _lib.library()
    return next(lib for macros, lib in libs if macros.get(macro) == value)


def adj_plans(words) -> dict:
    """K6's plans to time: the plan's stages (a run's 4 words at a time), one
    stage a 4 words of the key wherever they lie, and one stage a word
    (4-byte loads, an exit after every word): {name: (patterns, stages)}."""
    ptrs, strides = [w.data_ptr() for w in words], [w.stride(0) for w in words]
    m = len(words)
    chunks = list(range(0, m, perm_plan.CHUNK_WORDS)) + [m]
    return {"stages": perm_plan.key_plan(words),
            "4-word stages": (perm_plan.stage_patterns(
                perm_plan.word_widths(ptrs, strides, chunks), chunks), chunks),
            "a word a stage": ([0x1] * m, list(range(m + 1)))}


def command_keys(n: int, dev) -> dict:
    """The ``pipeline`` command's R || S at n rows (two tables of n / 2 from
    the generator, seeds 42 and 43, as the command makes them): {case:
    (key words, perm or None)} for K6 through the keys' sort order (K5's
    perm) and in place on sorted rows."""
    blocks = n // 2 // 100
    r, s = (generate_columns(blocks, seed=seed) for seed in (42, 43))
    both = RecordBatch.concat([RecordBatch.from_numpy(c["recid"], c["num"], c["strs"], c["valid"],
                                                      device=dev) for c in (r, s)])
    cases = {f"field {f} through perm": (key_words(both, f), words_sort(key_words(both, f))[0])
             for f in (2, 3)}
    order = cases["field 2 through perm"][1].long()
    strw = both.strw[order]
    cases["field 2 in place, sorted"] = ([strw[:, j] for j in range(strw.shape[1])], None)
    cases["field 1 in place, sorted"] = ([torch.sort(as_u32(both.num)).values.to(torch.int32)],
                                         None)
    return cases


def sweep_adj(dev, stream, libs) -> None:
    for n in ADJ_SIZES:
        adj = torch.empty(n, dtype=torch.bool, device=dev)
        for what, (words, perm) in command_keys(n, dev).items():
            if words[0].shape[0] != n:
                raise RuntimeError(f"perm_sweep: {what} has {words[0].shape[0]} rows, not {n}")
            want, row = adj_equal(words, perm), []
            for plan_name, (patterns, stages) in adj_plans(words).items():
                # every R on the plan's stages; the plan's R on the others
                for rows in (perm_plan.ADJ_ROW_CHOICES if plan_name == "stages"
                             else (perm_plan.ADJ_ROWS,)):
                    def call(rows=rows, patterns=patterns, stages=stages,
                             lib=lib_for(libs, "ADJ_R", rows)):
                        _check(lib.dbt_adj_equal(
                            _lib.ptr_array(words), _lib.stride_array(words),
                            _lib.int_array(patterns), _lib.int_array(stages), len(stages) - 1,
                            len(words), None if perm is None else perm.data_ptr(), n,
                            adj.data_ptr(), rows, stream), "K6")
                    row.append(f"R={rows} {plan_name} {kernel_ms(call, ('adj_equal_kernel',)):.4f}")
                    if not torch.equal(adj, want):
                        raise RuntimeError(f"perm_sweep: K6 {what}, {row[-1]} differs")
            ties = int(want.sum())
            print(f"[perm_sweep] K6 {n} rows, {what} (plan {perm_plan.key_plan(words)}, {ties} "
                  f"rows equal to their predecessor): " + ", ".join(row) + " ms", flush=True)


def grids(n: int, rows: int, dev) -> tuple:
    return (("card", perm_plan.blocks(n, rows, 1, dev)),
            ("2x card", perm_plan.blocks(n, rows, 2, dev)),
            ("full", perm_plan.blocks(n, rows, 0)))


def sweep_scatter(dev, gen, stream, libs) -> None:
    n = 2_000_000
    lo, m = n // 2, n - n // 2
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    vals = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    flags = torch.rand(n, device=dev, generator=gen) < 0.5
    perm_long = perm.long()
    lib = lib_for(libs, "SCATTER", 1)
    for turn in (1, 2):
        for v in (vals, flags) if turn == 1 else (flags, vals):
            elem = v.element_size()
            out = torch.empty(m, dtype=v.dtype, device=dev)
            want = unpermute(perm, v, lo, m)
            row = [f"R=1 (the package's) "
                   f"{kernel_ms(lambda: unpermute(perm, v, lo, m), ('unpermute_kernel',)):.4f}"]
            for rows in SCATTER_ROWS[elem][1:]:
                for grid, blocks in grids(n, rows, dev):
                    def call(rows=rows, blocks=blocks):
                        _check(lib.sweep_scatter(perm.data_ptr(), v.data_ptr(), n, lo, m,
                                                 out.data_ptr(), elem, rows, 1, blocks, stream),
                               "K7")
                    row.append(f"R={rows} {grid} grid ({blocks} blocks) "
                               f"{kernel_ms(call, ('sweep_scatter_kernel',)):.4f}")
                    if not torch.equal(out, want):
                        raise RuntimeError(f"perm_sweep: K7 scatter, {row[-1]} differs")
            lib_ms = kernel_ms(lambda: torch.empty(n, dtype=v.dtype, device=dev).scatter_(
                0, perm_long, v), None)
            print(f"[perm_sweep] K7 scatter {n} -> {m} {v.dtype} (turn {turn}): "
                  + ", ".join(row) + f" ms; library scatter_ of all rows {lib_ms:.4f} ms",
                  flush=True)


def sweep_gather(dev, gen, stream, libs) -> None:
    n = OVER_ROWS
    dest = torch.randint(0, CELLS, (n,), dtype=torch.int32, device=dev, generator=gen)
    word = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    live = torch.tensor(LIVE, dtype=torch.int32, device=dev)
    names = ("cells_count", "seg_scan_kernel", "cells_finish", "cells_fill_dead", "cells_place")
    k9 = {}
    for row_map in ("slots", "si"):
        k9[row_map] = kernel_ms(lambda row_map=row_map: stage_to_cells(
            dest, None, CELLS, CAP, [word], row_map, live, True), names)
    _, cnt, slots, ovf = stage_to_cells(dest, None, CELLS, CAP, [word], "slots", live, True)
    _, _, si, _ = stage_to_cells(dest, None, CELLS, CAP, [word], "si", live, True)
    if int(ovf):
        raise RuntimeError("perm_sweep: the over-budget shape overflowed its cells")
    first = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    staged = int(cnt.sum())
    mult = torch.zeros(n, dtype=torch.int32, device=dev)
    mult[:staged] = torch.randint(0, 3, (staged,), dtype=torch.int32, device=dev, generator=gen)
    got = unpermute_gather(slots, mult, first, CAP, live)
    if not torch.equal(got, unpermute(si, mult)):
        raise RuntimeError("perm_sweep: the gather and the scatter through si differ")
    s = slots[:LIVE].long()
    places = torch.where(s < CELLS * CAP, first.long()[(s // CAP).clamp(max=CELLS - 1)] + s % CAP,
                         n - 1)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    mul, shift = perm_plan.div_magic(CAP)
    row = []
    for rows in perm_plan.GATHER_ROW_CHOICES:
        for grid, blocks in grids(n, rows, dev):
            def call(rows=rows, blocks=blocks, lib=lib_for(libs, "UP_GATHER_R", rows)):
                _check(lib.dbt_unpermute_gather(
                    slots.data_ptr(), live.data_ptr(), 0, n, first.data_ptr(), CELLS, CAP, mul,
                    shift, mult.data_ptr(), n, out.data_ptr(), rows, int(rows > 1), blocks,
                    stream), "K7 gather")
            row.append(f"R={rows} {grid} grid ({blocks} blocks) "
                       f"{kernel_ms(call, ('unpermute_gather',)):.4f}")
            if not torch.equal(out, got):
                raise RuntimeError(f"perm_sweep: the gather at R={rows}, {blocks} blocks differs")
    scatter_ms = kernel_ms(lambda: unpermute(si, mult), ("unpermute_kernel",))
    lib_ms = kernel_ms(lambda: torch.index_select(mult, 0, places), None)
    print(f"[perm_sweep] K7 at {n} probe rows ({LIVE} live, {staged} staged) from {CELLS} cells "
          f"of {CAP}: gather " + ", ".join(row) + f" ms; scatter through si {scatter_ms:.4f} ms, "
          f"library index_select of the live rows' places {lib_ms:.4f} ms; K9 with row map "
          f"'slots' {k9['slots']:.4f} ms, 'si' {k9['si']:.4f} ms", flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("perm_sweep: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[perm_sweep] {smi or device_name(dev)}")
    gen = torch.Generator(device=dev).manual_seed(31)
    stream = torch.cuda.current_stream(dev).cuda_stream
    libs = build_variants()
    parts = set(argv or ("k6", "scatter", "gather"))
    if "k6" in parts:
        sweep_adj(dev, stream, libs)
    if "scatter" in parts:
        sweep_scatter(dev, gen, stream, libs)
    if "gather" in parts:
        sweep_gather(dev, gen, stream, libs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
