"""K7: un-permute (``csrc/unpermute.cu``) and its plain torch version.

Replaces the back-sorts of the JAX package that return a per-sorted-row
word to original row order (``ops/hash_join.py:242-253``; the same function
as ``ops/movement.py:235`` ``packed_keep_backsort`` and the un-permute of
``ops/sort.py:240``).
"""

from __future__ import annotations

import torch

from . import _lib

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
