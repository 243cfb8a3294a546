"""The tiles of K2 and K3 (``csrc/scan.cuh``, ``csrc/compact.cu``) swept on
the card.

Builds copies of K2's source under ``build/scan_sweep/`` with 128, 256 and
512 threads a block and 16 rows a thread, and with 256 and 512 threads and
8 rows a thread (tiles of 2048 to 8192 rows), and copies of K3's with 128
and 256 threads and 16 rows a thread (its count kernel reads a thread's 16
rows as one vector, and its two staged words fill 32 KB of static shared
memory at 256 threads) and 1, 2, 4 or 8 tiles a block of its count kernel,
all ``nvcc`` processes started together.  Each is timed through its C entry
at the main path's shape and beyond L2: K2 as stage A's segmented add at 2M
rows (bool and int32 values) and at 16M rows, K3 with one word at 2M rows and
with the row index at 16M rows.  A time is the median device time of the
named kernels over 20 calls (torch.profiler), in ms, the memset left out;
inputs are random, made on the card from a seed.  ``kernels/scan_plan.py``'s
THREADS and ITEMS and ``compact.cu``'s COUNT_TILES are the ones these
readings chose.

    python -m database_technology_algorithms_tpu_torch.tools.scan_sweep
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess

import torch

from ..kernels import _lib, scan_plan
from . import device_name

K2_VARIANTS = ((128, 16), (256, 16), (512, 16), (256, 8), (512, 8))  # (threads, rows a thread)
K3_VARIANTS = ((128, 16, 4), (256, 16, 1), (256, 16, 2), (256, 16, 4), (256, 16, 8))  # + count tiles
COUNT_TILES = 4  # compact.cu's
REPS = 20


def _patched(name: str, threads: int, items: int, count_tiles: int) -> str:
    text = (_lib.CSRC / name).read_text()
    edits = {"scan.cuh": (("SCAN_THREADS", scan_plan.THREADS, threads),
                          ("SCAN_ITEMS", scan_plan.ITEMS, items)),
             "compact.cu": (("COUNT_TILES", COUNT_TILES, count_tiles),)}.get(name, ())
    for const, old_value, value in edits:
        old = f"constexpr int {const} = {old_value};"
        if old not in text:
            raise RuntimeError(f"scan_sweep: {old!r} not found in {name}")
        text = text.replace(old, f"constexpr int {const} = {value};")
    return text


def build_variants() -> dict:
    """{("K2", threads, rows) or ("K3", threads, rows, count tiles): the
    loaded library of that variant}."""
    root = _lib.BUILD_DIR.parent / "scan_sweep"
    shutil.rmtree(root, ignore_errors=True)
    nvcc, procs = _lib._nvcc(), []
    variants = [("K2", *v) for v in K2_VARIANTS] + [("K3", *v) for v in K3_VARIANTS]
    for v in variants:
        d = root / "x".join(map(str, v))
        d.mkdir(parents=True)
        source = "seg_scan.cu" if v[0] == "K2" else "compact.cu"
        for name in ("common.cuh", "scan.cuh", source):
            (d / name).write_text(_patched(name, v[1], v[2], v[3] if v[0] == "K3" else COUNT_TILES))
        procs.append((v, d, subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-shared", str(d / source), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for v, d, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"scan_sweep: nvcc failed for {v}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        name = "dbt_seg_scan" if v[0] == "K2" else "dbt_compact"
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = _lib._SIGNATURES[name]
        libs[v] = lib
    return libs


def kernel_ms(fn, names: tuple) -> float:
    """Median device time of one call's kernels whose names hold one of
    `names` ("" holds any), over REPS calls; a trace that lost one of them
    is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                for name in names:
                    if name in ev.name:
                        by_name.setdefault(name, []).append(ev.device_time)
        if set(by_name) == set(names) and all(len(v) % REPS == 0 for v in by_name.values()):
            return sum(statistics.median(v) * len(v) / REPS for v in by_name.values()) / 1e3
    raise RuntimeError(f"scan_sweep: torch.profiler saw {({k: len(v) for k, v in by_name.items()})}"
                       f" of {REPS} calls of {names}")


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_sweep: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    libs = build_variants()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[scan_sweep] {smi or device_name(dev)}")
    gen = torch.Generator(device=dev).manual_seed(21)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def k2(lib, tile, flags, vals):
        n = vals.shape[0]
        words = 2 + 2 * -(-n // tile)
        out = torch.empty(n, dtype=torch.int32, device=dev)
        scratch = torch.empty(words, dtype=torch.int32, device=dev)

        def call():
            err = lib.dbt_seg_scan(flags.data_ptr(), vals.data_ptr(), vals.element_size(),
                                   out.data_ptr(), scratch.data_ptr(), n, 0, 0, 0, tile, words,
                                   stream)
            if err:
                raise RuntimeError(f"scan_sweep: K2 launch failed ({err})")
        return call

    def k3(lib, tile, keep, payload):
        n = keep.shape[0]
        words = 2 + -(-n // tile)
        outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in payload]
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        src = (ctypes.c_void_p * len(payload))(
            *[None if isinstance(w, int) else w.data_ptr() for w in payload])
        bases = (ctypes.c_uint32 * len(payload))(*[w if isinstance(w, int) else 0 for w in payload])

        def call():
            err = lib.dbt_compact(keep.data_ptr(), n, src, bases, _lib.ptr_array(outs),
                                  len(payload), scratch.data_ptr(), tile, words, stream)
            if err:
                raise RuntimeError(f"scan_sweep: K3 launch failed ({err})")
        return call

    for n in (2 * 1024 * 1024, 16 * 1024 * 1024):
        flags = torch.rand(n, device=dev, generator=gen) < 0.3
        bools = torch.rand(n, device=dev, generator=gen) < 0.3
        vals = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
        big = n >= 16 * 1024 * 1024
        for v in K2_VARIANTS:
            lib, tile = libs[("K2", *v)], v[0] * v[1]
            row = [f"int32 values {kernel_ms(k2(lib, tile, flags, vals), ('seg_scan_kernel',)):.4f}"]
            if not big:
                row.append(f"bool values "
                           f"{kernel_ms(k2(lib, tile, flags, bools), ('seg_scan_kernel',)):.4f}")
            print(f"[scan_sweep] K2 {n} rows, {v[0]} threads x {v[1]} rows (tile {tile}): "
                  + ", ".join(row) + " ms", flush=True)
        for v in K3_VARIANTS:
            lib, tile = libs[("K3", *v)], v[0] * v[1]
            call = k3(lib, tile, flags, (0,) if big else (vals,))
            print(f"[scan_sweep] K3 {n} rows, {'the row index' if big else 'a word'}, {v[0]} "
                  f"threads x {v[1]} rows, {v[2]} tiles a count block: count "
                  f"{kernel_ms(call, ('compact_count',)):.4f}, both "
                  f"{kernel_ms(call, ('compact_count', 'compact_move')):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
