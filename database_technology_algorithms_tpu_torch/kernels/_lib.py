"""Build, load and call the CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into an object,
one ``nvcc`` process per source, all started together; the objects link
into one shared library with a plain C interface, loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads what is built.  Builds
go to ``build/torch_kernels/`` beside the package, at first use.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES = {
    "radix_sort": 0, "seg_scan": 0, "compact": 0, "take_fill": 0,
    "words_sort": 0, "adj_equal": 0, "unpermute": 0, "unpermute_gather": 0,
    "hash_words": 0, "stage_cells": 0, "member_mult": 0,
    "tile_copy": 0, "row_move": 0, "run_aggregate": 0, "expand_sources": 0,
    "sorted_probe": 0, "hash_set_build": 0, "hash_set_probe": 0, "bucket_probe": 0,
    "topk_runs": 0, "hot_hashes": 0, "in_hot_set": 0, "range_dest": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))  # the toolkit's default prefix
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile the sources if their hash has no library yet; return its path.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<name>.log``.
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"libdbt_torch_kernels_{tag}.so"
    if lib.exists():
        return lib
    objdir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = objdir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc={p.returncode})\n{out}")
        if p.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        capture_output=True, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"link failed:\n{link.stdout}\n{link.stderr}")
    lib.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, lib)
    shutil.rmtree(objdir, ignore_errors=True)
    return lib


_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I64 = ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_PU32 = ctypes.POINTER(ctypes.c_uint32)
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "dbt_error_string": ([_I], ctypes.c_char_p),
    "dbt_seg_scan": ([_P, _P, _I, _P, _P, _I64, _I, _I, _I, _I64, _I64, _P], _I),
    "dbt_radix_scratch_words": ([_I64, _I], _I64),
    "dbt_view_sort": ([_P, _P, _I64, _PI32, _I, _P, _P, _P, _PP, _PP, _I, _I, _P, _P], _I),
    "dbt_compact": ([_P, _I64, _PP, _PU32, _PP, _I, _P, _I64, _I64, _P], _I),
    "dbt_take_fill": ([_P, _I64, _I64, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _P],
                      _I),
    "dbt_words_sort": ([_PP, _PI64, _I, _PI32, _I, _P, _I64, _P, _P, _PP, _PP, _I, _I, _P, _P],
                       _I),
    "dbt_adj_equal": ([_PP, _PI64, _PI32, _PI32, _I, _I, _P, _I64, _P, _I, _P], _I),
    "dbt_unpermute": ([_P, _P, _I64, _I64, _I64, _P, _I, _P], _I),
    "dbt_unpermute_gather": ([_P, _P, _I64, _I64, _P, _I64, _I64, _U64, _I, _P, _I64, _P, _I,
                              _I, _I, _P], _I),
    "dbt_hash_words": ([_PP, _PI64, _I, _I64, _U32, _I, _P, _P], _I),
    "dbt_value_boundaries_scratch_words": ([_I64, _I64, _I64], _I64),
    "dbt_value_boundaries": ([_P, _I64, _I64, _P, _P, _I64, _I64, _P], _I),
    "dbt_stage_cells_scratch_words": ([_I64, _I64, _I64], _I64),
    "dbt_stage_cells": ([_P, _P, _P, _I64, _I64, _I64, _PP, _PI64, _PP, _I, _U32, _P, _P, _P, _P,
                         _P, _I64, _I64, _I, _P], _I),
    "dbt_member_mult": ([_PP, _PI64, _PP, _PI64, _I, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P,
                         _I64, _I64, _I, _P], _I),
    "dbt_tile_copy": ([_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I64, _P, _P], _I),
    "dbt_row_move": ([_P, _P, _P, _I64, _I, _I64, _I, _P, _I64, _I, _I, _P], _I),
    "dbt_run_aggregate": ([_P, _P, _PP, _I, _I64, _P, _P, _P, _I64, _P], _I),
    "dbt_expand_sources": ([_P, _I64, _I64, _P, _I, _I, _I64, _P], _I),
    "dbt_sorted_probe": ([_P, _I64, _P, _I64, _P, _I64, _P, _I64, _P, _I, _I, _I, _P, _P, _P], _I),
    "dbt_hash_set_build": ([_P, _I64, _P, _I64, _P, _I64, _I, _P, _I, _I, _I, _I, _I64, _P], _I),
    "dbt_hash_set_probe": ([_P, _I64, _P, _P, _I64, _P, _I64, _I, _P, _P, _P, _I, _I, _I, _P],
                           _I),
    "dbt_bucket_probe": ([_P, _P, _I64, _P, _P, _I64, _I64, _I, _I, _I, _P, _P, _P, _P], _I),
    "dbt_topk_runs_scratch_words": ([_I64, _I], _I64),
    "dbt_topk_runs": ([_P, _I64, _P, _I, _P, _P, _P, _I64, _P], _I),
    "dbt_hot_lists": ([_P, _P, _I64, _P, _P, _P, _I64, _P, _I64, _P, _P, _I, _I, _I64, _P], _I),
    "dbt_in_hot_set": ([_P, _I64, _P, _I64, _P, _I, _I, _I, _I, _I64, _P], _I),
    "dbt_range_dest": ([_PP, _PI64, _I, _I64, _PP, _PI64, _I64, _P, _I, _I64, _P], _I),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with every entry point's argument types declared
    (a pointer passed without ``c_void_p`` would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (on `device`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr_array(tensors) -> ctypes.Array | None:
    """Host array of device pointers for an entry point's column list."""
    if not tensors:
        return None
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check_columns(name: str, words, n: int, device) -> None:
    """Raise unless every word is an int32 CUDA column of `n` rows on
    `device`; a column may be strided (a column of a row-major matrix)."""
    for w in words:
        if w.device != device:
            raise ValueError(f"{name}: column on {w.device}, expected {device}")
        if w.dtype != torch.int32:
            raise TypeError(f"{name}: expected torch.int32 columns, got {w.dtype}")
        if w.shape != (n,):
            raise ValueError(f"{name}: column of shape {tuple(w.shape)}, expected ({n},)")


def stride_array(words) -> ctypes.Array:
    """Host array of the row strides (in words) of 1-D columns."""
    return (ctypes.c_int64 * len(words))(*[w.stride(0) for w in words])


def int_array(values) -> ctypes.Array:
    """Host array of C ints for an entry point's per-word plan."""
    return (ctypes.c_int * len(values))(*values)


def raise_on_error(err: int, kernel: str) -> None:
    if err:
        msg = library().dbt_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({err}: {msg})")
