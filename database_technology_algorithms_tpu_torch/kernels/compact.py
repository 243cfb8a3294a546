"""K3: stable compaction (``csrc/compact.cu``, tiles planned by
``scan_plan``) and its plain torch version.

Replaces the JAX package's ``compact_words`` (``ops/movement.py:479``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib, scan_plan


def _row_index(slot: int, n: int, device) -> torch.Tensor:
    scan_plan.check_row_index("compact_words", slot, n)
    return torch.arange(slot, slot + n, dtype=torch.int32, device=device)


def compact_words(
    keep: torch.Tensor, payload: tuple
) -> tuple[torch.Tensor, tuple]:
    """Rows with `keep` True to the front, in order, then the others, in
    order, for every word of `payload`.  A word is an int32 tensor [N], or
    an int ``b``, which stands for the row index plus ``b`` (``b + i`` at
    row i) and is written without reading an ``arange``.  Returns (count as
    a 0-d int32 tensor on keep's device, the moved words as int32 tensors).

    CPU tensors take the plain version.  On CUDA: two kernel launches (the
    tiles' counts and offsets, then the moves; one more move launch for
    every eight words past the first eight), and no host synchronization.
    """
    if keep.device.type == "cpu":
        return compact_words_plain(keep, payload)
    dev = keep.device
    n = keep.shape[0]
    _lib.check_cuda("compact_words keep", keep, torch.bool)
    for w in payload:
        if isinstance(w, int):
            scan_plan.check_row_index("compact_words", w, n)
            continue
        _lib.check_cuda("compact_words payload", w, torch.int32, dev)
        if w.shape != (n,):
            raise ValueError("compact_words: payload words must be [N] like keep")
    scan_plan.check_rows("compact_words", n)
    outs = tuple(torch.empty(n, dtype=torch.int32, device=dev) for _ in payload)
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=dev), outs
    words = scan_plan.compact_scratch_words(n)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    k = len(payload)
    src = (ctypes.c_void_p * k)(*[None if isinstance(w, int) else w.data_ptr() for w in payload])
    bases = (ctypes.c_uint32 * k)(*[w if isinstance(w, int) else 0 for w in payload])
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_compact(
            keep.data_ptr(), n, src if k else None, bases if k else None,
            _lib.ptr_array(outs), k, scratch.data_ptr(), scan_plan.TILE, words,
            _lib.stream_of(keep),
        )
    _lib.raise_on_error(err, "compact_words")
    _lib.LAUNCHES["compact"] += 1
    return scratch[scan_plan.COUNT_WORD], outs


def compact_words_plain(
    keep: torch.Tensor, payload: tuple
) -> tuple[torch.Tensor, tuple]:
    """The same compaction as one stable torch.sort of the drop flag."""
    n = keep.shape[0]
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return keep.sum(dtype=torch.int32), tuple(
        (_row_index(w, n, keep.device) if isinstance(w, int) else w)[order] for w in payload)
