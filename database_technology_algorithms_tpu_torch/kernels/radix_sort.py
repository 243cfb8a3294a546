"""K1: the view sort (``csrc/radix_sort.cu``) and its plain torch version.

Replaces the JAX package's ``packed_u32_view_sort`` (``ops/sort.py:190``).
"""

from __future__ import annotations

import torch

from ..batch import as_u32
from . import _lib, radix_plan


def view_sort(
    inact: torch.Tensor, key: torch.Tensor, extra: tuple = ()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple]:
    """Sort rows by (inact, key as u32, row index).

    `inact` is bool[N] (True sorts last), `key` and each `extra` word int32[N]
    holding u32 bits.  Returns (s_key, perm int32, s_act bool, extras), with
    ``s_key[i] = key[perm[i]]``, ``s_act[i] = ~inact[perm[i]]`` and every
    extra word gathered by perm.

    CPU tensors take the plain version; CUDA tensors launch the kernel, for
    at most 2^31 - 1 rows (``radix_plan.MAX_ROWS``), and gather the extra
    words under ``radix_plan.gather_packed``.
    """
    if key.device.type == "cpu":
        return view_sort_plain(inact, key, extra)
    dev = key.device
    n = key.shape[0]
    _lib.check_cuda("view_sort key", key, torch.int32)
    _lib.check_cuda("view_sort inact", inact, torch.bool, dev)
    for w in extra:
        _lib.check_cuda("view_sort extra", w, torch.int32, dev)
    if any(t.shape != (n,) for t in (inact, *extra)):
        raise ValueError("view_sort: inact and extra words must be [N] like key")
    s_key = torch.empty_like(key)
    perm = torch.empty_like(key)
    s_act = torch.empty_like(inact)
    ex_out = tuple(torch.empty_like(w) for w in extra)
    if n == 0:
        return s_key, perm, s_act, ex_out
    radix_plan.check_rows("view_sort", n)
    sched = radix_plan.view_sort_schedule()
    lib = _lib.library()
    scratch = torch.empty(
        lib.dbt_radix_scratch_words(n, len(sched)), dtype=torch.int32, device=dev
    )
    with torch.cuda.device(dev):
        err = lib.dbt_view_sort(
            key.data_ptr(), inact.data_ptr(), n,
            radix_plan.schedule_array(sched), len(sched),
            s_key.data_ptr(), perm.data_ptr(), s_act.data_ptr(),
            _lib.ptr_array(extra), _lib.ptr_array(ex_out), len(extra),
            int(radix_plan.gather_packed(n, len(extra))), scratch.data_ptr(),
            _lib.stream_of(key),
        )
    _lib.raise_on_error(err, "view_sort")
    _lib.LAUNCHES["radix_sort"] += 1
    radix_plan.note_kinds(scratch, len(sched))
    return s_key, perm, s_act, ex_out


def view_sort_plain(
    inact: torch.Tensor, key: torch.Tensor, extra: tuple = ()
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple]:
    """The same sort as one stable torch.sort of ``inact<<32 | key``."""
    composite = (inact.long() << 32) | as_u32(key)
    perm = torch.sort(composite, stable=True).indices
    return (
        key[perm],
        perm.to(torch.int32),
        ~inact[perm],
        tuple(w[perm] for w in extra),
    )
