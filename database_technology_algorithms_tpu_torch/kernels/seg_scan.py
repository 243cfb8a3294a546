"""K2: segmented scan (``csrc/seg_scan.cu`` on the single-pass engine of
``csrc/scan.cuh``, planned by ``scan_plan``) and its plain torch version.

Replaces the JAX package's ``ops/scan.py`` blocked scans (``:28-137``).
"""

from __future__ import annotations

import torch

from ..batch import U32_MASK, u32_bits
from . import _lib, scan_plan

OPS = {"add": 0, "min": 1, "max": 2}


def seg_scan(
    flags: torch.Tensor | None,
    vals: torch.Tensor,
    op: str = "add",
    signed: bool = False,
    reverse: bool = False,
) -> torch.Tensor:
    """Inclusive scan of `vals` (int32 holding u32, or i32 if `signed`; or
    bool, read as 0/1) that restarts at every row whose `flags` is True;
    `flags=None` scans without segments.  `op` is "add" (wraps mod 2^32),
    "min" or "max".  `reverse` scans from the last row to the first, as
    ``flip(scan(flip(flags), flip(vals)))``.  Returns int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if vals.device.type == "cpu":
        return seg_scan_plain(flags, vals, op, signed, reverse)
    code = OPS[op]
    n = vals.shape[0]
    _lib.check_cuda("seg_scan vals", vals, torch.bool if vals.dtype == torch.bool else torch.int32)
    if flags is not None:
        _lib.check_cuda("seg_scan flags", flags, torch.bool, vals.device)
        if flags.shape != vals.shape:
            raise ValueError(f"seg_scan: flags {tuple(flags.shape)} != vals {tuple(vals.shape)}")
    scan_plan.check_rows("seg_scan", n)
    out = torch.empty(vals.shape, dtype=torch.int32, device=vals.device)
    if n == 0:
        return out
    words = scan_plan.scan_scratch_words(n)
    scratch = torch.empty(words, dtype=torch.int32, device=vals.device)
    lib = _lib.library()
    with torch.cuda.device(vals.device):
        err = lib.dbt_seg_scan(
            None if flags is None else flags.data_ptr(), vals.data_ptr(), vals.element_size(),
            out.data_ptr(), scratch.data_ptr(), n, code, int(signed), int(reverse),
            scan_plan.TILE, words, _lib.stream_of(vals),
        )
    _lib.raise_on_error(err, "seg_scan")
    _lib.LAUNCHES["seg_scan"] += 1
    return out


def seg_scan_plain(
    flags: torch.Tensor | None,
    vals: torch.Tensor,
    op: str = "add",
    signed: bool = False,
    reverse: bool = False,
) -> torch.Tensor:
    """The same function in int64 torch ops, on any device."""
    if op not in OPS:
        raise KeyError(op)
    if reverse:
        f = None if flags is None else flags.flip(0)
        return seg_scan_plain(f, vals.flip(0), op, signed, False).flip(0)
    n = vals.shape[0]
    v = vals.long() if signed else vals.long() & U32_MASK
    if flags is None:
        flags = torch.zeros(n, dtype=torch.bool, device=vals.device)
    if op == "add":
        incl = torch.cumsum(v, 0)
        excl = incl - v
        # the exclusive sum at the row's run start, carried to the row
        rows = torch.arange(n, device=vals.device)
        last_start = torch.cummax(torch.where(flags, rows, -1), 0).values
        base = torch.where(
            last_start >= 0, excl[last_start.clamp(min=0)], torch.zeros_like(v)
        )
        return u32_bits(incl - base)
    # runs are numbered by the flags seen so far; offsetting each run by its
    # number (a gap of 2^33 > the value range) keeps earlier runs out of the
    # running min/max
    seg = torch.cumsum(flags.long(), 0) << 33
    if op == "max":
        return u32_bits(torch.cummax(seg + v, 0).values - seg)
    return u32_bits(torch.cummin(v - seg, 0).values + seg)
