"""Deterministic synthetic-data generator (numpy copy of the JAX package's
``io/generator.py``; the same seed gives the same rows).

Mirrors the reference generator's shape (``main.cpp:41-77``): sequential
``recid``; ``num`` uniform in ``[0, nblocks*30)``; a random 5-char lowercase
``str``; the literal ``"Hola"`` planted at row 1 of every block.
"""

from __future__ import annotations

import numpy as np

from ..batch import MAX_RECORDS_PER_BLOCK, STR_PAD, RecordBatch

_LOWER = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
_HOLA = np.frombuffer(b"Hola", dtype=np.uint8)


def generate_columns(
    nblocks: int,
    seed: int = 42,
    key_range: int | None = None,
    recid_start: int = 0,
    plant_hola: bool = True,
    zipf_a: float | None = None,
    str_len: int = 5,
) -> dict:
    """Generate one table's SoA columns (host numpy)."""
    rng = np.random.default_rng(seed)
    n = nblocks * MAX_RECORDS_PER_BLOCK
    if key_range is None:
        key_range = max(nblocks * 30, 1)

    recid = (recid_start + np.arange(n)).astype(np.uint32)
    if zipf_a is not None:
        num = (rng.zipf(zipf_a, size=n) - 1) % key_range
        num = num.astype(np.uint32)
    else:
        num = rng.integers(0, key_range, size=n, dtype=np.uint32)

    strs = np.zeros((n, STR_PAD), dtype=np.uint8)
    strs[:, :str_len] = _LOWER[rng.integers(0, 26, size=(n, str_len))]
    if plant_hola and nblocks > 0:
        hola_rows = np.arange(nblocks) * MAX_RECORDS_PER_BLOCK + 1
        strs[hola_rows] = 0
        strs[hola_rows, : len(_HOLA)] = _HOLA
    valid = np.ones(n, dtype=bool)
    return {"recid": recid, "num": num, "strs": strs, "valid": valid}


def generate_batch(nblocks: int, seed: int = 42, device=None, **kw) -> RecordBatch:
    """One generated table as a batch on `device` (default: the card)."""
    cols = generate_columns(nblocks, seed=seed, **kw)
    return RecordBatch.from_numpy(
        cols["recid"], cols["num"], cols["strs"], cols["valid"],
        normalize=False, device=device,
    )


def generate_pair_files(path1: str, path2: str, nblocks: int, seed: int = 42, **kw) -> None:
    """Write the two-file fixture the reference's main program creates
    (``main.cpp:36-79``): seeds `seed` and `seed + 1`, both files with the
    same recids."""
    from .blockfile import write_blockfile

    cols1 = generate_columns(nblocks, seed=seed, **kw)
    cols2 = generate_columns(nblocks, seed=seed + 1, **kw)
    cols2["recid"] = cols1["recid"]
    write_blockfile(path1, cols1)
    write_blockfile(path2, cols2)
