"""K7: un-permute (``csrc/unpermute.cu``) in its two forms, and their plain
torch versions.

The scatter replaces the back-sorts of the JAX package that return a
per-sorted-row word to original row order (``ops/hash_join.py:242-253``;
the same function as ``ops/movement.py:235`` ``packed_keep_backsort`` and
the un-permute of ``ops/sort.py:240``).  The gather replaces the tiled
join's return of its counts to probe order (``ops/hash_join.py:470-489``, a
compaction of the occupied slots and a sort by the staging permutation).
The scatter runs one thread a row; the gather follows ``perm_plan``: R rows
a thread, 16-byte vectors, a grid of a few waves of the card's blocks.
"""

from __future__ import annotations

import torch

from . import _lib, perm_plan, rowmove_plan

_ELEM_BYTES = {torch.int32: 4, torch.bool: 1}


def unpermute(
    perm: torch.Tensor, vals: torch.Tensor, lo: int = 0, m: int | None = None
) -> torch.Tensor:
    """``out[perm[i] - lo] = vals[i]`` for every i with ``lo <= perm[i] <
    lo + m``; returns out, [m] of vals' dtype (int32 or bool).  `perm` must
    be a permutation of [0, N) as int32 and ``lo + m <= N``, so that every
    slot of out is written exactly once.  `m` defaults to ``N - lo``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    n = perm.shape[0]
    m = n - lo if m is None else m
    if lo < 0 or m < 0 or lo + m > n:
        raise ValueError(f"unpermute: window [{lo}, {lo + m}) outside [0, {n})")
    if perm.device.type == "cpu":
        return unpermute_plain(perm, vals, lo, m)
    dev = perm.device
    _lib.check_cuda("unpermute perm", perm, torch.int32)
    if vals.dtype not in _ELEM_BYTES:
        raise TypeError(f"unpermute: expected int32 or bool values, got {vals.dtype}")
    _lib.check_cuda("unpermute vals", vals, vals.dtype, dev)
    if vals.shape != (n,) or perm.dim() != 1:
        raise ValueError("unpermute: perm and vals must both be [N]")
    out = torch.empty(m, dtype=vals.dtype, device=dev)
    if m == 0:
        return out
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_unpermute(
            perm.data_ptr(), vals.data_ptr(), n, lo, m, out.data_ptr(),
            _ELEM_BYTES[vals.dtype], _lib.stream_of(perm),
        )
    _lib.raise_on_error(err, "unpermute")
    _lib.LAUNCHES["unpermute"] += 1
    return out


def unpermute_plain(perm: torch.Tensor, vals: torch.Tensor, lo: int, m: int) -> torch.Tensor:
    """The same scatter as an index assignment on the in-window rows."""
    d = perm.long() - lo
    ok = (d >= 0) & (d < m)
    out = vals.new_zeros(m)
    out[d[ok]] = vals[ok]
    return out


def _check_gather(slot_of_row, vals, first, cap) -> None:
    for name, t in (("slot_of_row", slot_of_row), ("vals", vals), ("first", first)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"unpermute_gather: {name} must be a 1-D int32 tensor")
    perm_plan.check_gather("unpermute_gather", slot_of_row.shape[0], first.shape[0], cap,
                           vals.shape[0])


def unpermute_gather(slot_of_row: torch.Tensor, vals: torch.Tensor, first: torch.Tensor,
                     cap: int, count=None) -> torch.Tensor:
    """``out[i] = vals[first[s // cap] + s % cap]`` for ``s =
    slot_of_row[i]`` where ``i < count`` and ``s < nparts * cap`` (``nparts
    = len(first)``), else 0; int32 [N].

    With K9's "slots" row map of rows staged into [nparts, cap] cells and
    per-cell values written compacted from ``first`` (the exclusive sum of
    the cell counts, as K10's ``out_pos``), this returns each row's value
    to row order: the inverse of ``unpermute(si, ·)`` on the same staging
    while nothing overflowed.  An index at or past ``len(vals)`` gives 0,
    so an attempt that overflowed reads nothing out of bounds.  `count` is
    an int or a 0-d integer tensor on the device (rows at or past it are
    not read); None means every row.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check_gather(slot_of_row, vals, first, cap)
    if slot_of_row.device.type == "cpu":
        return unpermute_gather_plain(slot_of_row, vals, first, cap, count)
    dev = slot_of_row.device
    for name, t in (("slot_of_row", slot_of_row), ("vals", vals), ("first", first)):
        _lib.check_cuda(f"unpermute_gather {name}", t, torch.int32, dev)
    n = slot_of_row.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    cnt, cnt_host = rowmove_plan.count_arg(count, n, dev)
    mult, shift = perm_plan.div_magic(cap)
    rows = perm_plan.GATHER_ROWS
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_unpermute_gather(
            slot_of_row.data_ptr(), None if cnt is None else cnt.data_ptr(), cnt_host, n,
            first.data_ptr(), first.shape[0], cap, mult, shift, vals.data_ptr(), vals.shape[0],
            out.data_ptr(), rows, int(perm_plan.vector_ok(slot_of_row.data_ptr(), out.data_ptr())),
            perm_plan.blocks(n, rows, perm_plan.GATHER_WAVES, dev), _lib.stream_of(out),
        )
    _lib.raise_on_error(err, "unpermute_gather")
    _lib.LAUNCHES["unpermute_gather"] += 1
    return out


def unpermute_gather_plain(slot_of_row: torch.Tensor, vals: torch.Tensor, first: torch.Tensor,
                           cap: int, count=None) -> torch.Tensor:
    """The same gather as torch indexing of the rows whose slot is in a cell."""
    _check_gather(slot_of_row, vals, first, cap)
    n = slot_of_row.shape[0]
    s = slot_of_row.long()
    ok = (s >= 0) & (s < first.shape[0] * cap)
    if count is not None:
        ok &= rowmove_plan.live_positions(n, count, s.device)
    s = torch.where(ok, s, 0)
    at = first.long()[s // cap] + s % cap
    ok &= (at >= 0) & (at < vals.shape[0])
    if vals.shape[0] == 0:
        return torch.zeros(n, dtype=torch.int32, device=s.device)
    return torch.where(ok, vals[torch.where(ok, at, 0)], 0).to(torch.int32)
