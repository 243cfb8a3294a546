"""ctypes bindings for the native block-file library (``native/dbtio.cpp``;
the port's copy of the JAX package's ``io/native.py``).

This is host IO: it transposes the on-disk records into the columns the
engine uses, faster than the numpy codec of ``blockfile.py`` for multi-GB
files.  The reader serves ``read_blockfile``; the writer and the pair
generator are bound as the JAX package binds them, and no path of the port
calls them yet (the numpy codec writes every file).  The library is
built at first use with the repository's ``native/Makefile`` into
``build/torch_native/`` (not the JAX package's ``build/libdbtio.so``, so
that the two packages never write or load one file at the same time).
Without a compiler every entry point returns None and the callers use the
numpy codec.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess

import numpy as np

from ..batch import STR_PAD

_REPO = pathlib.Path(__file__).resolve().parents[2]
_BUILD = _REPO / "build" / "torch_native"
LIB_PATH = _BUILD / "libdbtio.so"


def _build() -> bool:
    """Build into a directory of this process, then move the library into
    place in one rename, so that a process loading it never sees a
    half-written file while another builds."""
    tmp = _BUILD / f"tmp_{os.getpid()}"
    try:
        subprocess.run(
            ["make", "-C", str(_REPO / "native"), f"BUILD={tmp}"],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp / "libdbtio.so", LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@functools.cache
def get_lib():
    """The loaded library, built if needed; None if it cannot be built or
    loaded."""
    if not LIB_PATH.exists() and not _build():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.dbt_count_rows.argtypes = [ctypes.c_char_p]
    lib.dbt_count_rows.restype = ctypes.c_long
    lib.dbt_read_blockfile_mt.argtypes = [
        ctypes.c_char_p, u32p, u32p, u8p, u8p, ctypes.c_long, ctypes.c_int,
    ]
    lib.dbt_read_blockfile_mt.restype = ctypes.c_long
    lib.dbt_write_blockfile.argtypes = [
        ctypes.c_char_p, u32p, u32p, u8p, u8p, ctypes.c_long,
    ]
    lib.dbt_write_blockfile.restype = ctypes.c_long
    lib.dbt_generate_pair.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_uint32, ctypes.c_uint32,
    ]
    lib.dbt_generate_pair.restype = ctypes.c_long
    return lib


def count_rows_native(path: str) -> int | None:
    """Live rows of a block file (the sum of each block's ``nreserved``,
    at most 100 a block), or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.dbt_count_rows(os.fsencode(path))
    return None if n < 0 else int(n)


def read_blockfile_native(path: str, nthreads: int | None = None) -> dict | None:
    """A block file as host columns (those of ``read_blockfile_numpy``), read
    by `nthreads` threads (default: min(cores, 8)); None on failure."""
    lib = get_lib()
    n = count_rows_native(path)
    if n is None:
        return None
    recid = np.empty(n, np.uint32)
    num = np.empty(n, np.uint32)
    strs = np.empty((n, STR_PAD), np.uint8)
    valid = np.empty(n, np.uint8)
    t = nthreads or min(os.cpu_count() or 1, 8)
    got = lib.dbt_read_blockfile_mt(os.fsencode(path), recid, num, strs, valid, n, int(t))
    if got != n:
        return None
    return {"recid": recid, "num": num, "strs": strs, "valid": valid.astype(bool)}



def write_blockfile_native(path: str, cols: dict) -> int | None:
    """Write host columns (those of ``read_blockfile_numpy``; `strs` u8[N,
    <=128], zero-padded to 128 bytes here; `valid` all true when absent) as
    a block file of 100 records a block; the number of blocks, or None."""
    lib = get_lib()
    if lib is None:
        return None
    recid = np.ascontiguousarray(cols["recid"], np.uint32)
    num = np.ascontiguousarray(cols["num"], np.uint32)
    strs = np.ascontiguousarray(cols["strs"], np.uint8)
    if strs.shape[1] != STR_PAD:
        padded = np.zeros((len(recid), STR_PAD), np.uint8)
        padded[:, : strs.shape[1]] = strs
        strs = padded
    valid = np.ascontiguousarray(np.asarray(cols.get("valid", np.ones(len(recid), bool))),
                                 np.uint8)
    nblocks = lib.dbt_write_blockfile(os.fsencode(path), recid, num, strs, valid, len(recid))
    return None if nblocks < 0 else int(nblocks)


def generate_pair_native(path1: str, path2: str, nblocks: int, seed: int,
                         key_range: int) -> int | None:
    """The reference generator's two files of `nblocks` blocks each
    (``dbt_generate_pair``: keys below `key_range`, at least 1); the rows
    written a file, or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.dbt_generate_pair(os.fsencode(path1), os.fsencode(path2), nblocks, seed,
                              max(key_range, 1))
    return None if n < 0 else int(n)
