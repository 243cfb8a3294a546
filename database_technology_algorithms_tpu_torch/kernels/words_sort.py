"""K5: the multi-word key sort (``csrc/words_sort.cu``) and its plain torch
version.

Replaces the variadic ``lax.sort`` of the JAX package's ``sort_keys``
(``ops/sort.py:151-161``) and the stable passes of its exact string fallback
``_lsd_exact_string_perm`` (``ops/sort.py:63``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import as_u32
from . import _lib


def words_sort(
    words: Sequence[torch.Tensor],
    inact: torch.Tensor | None = None,
    extra: tuple = (),
) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """Order rows by (inact, words[0], ..., words[-1], row index).

    `words` are int32[N] columns holding u32 bits, most significant first;
    a column may be strided (``strw[:, j]`` is sorted where it lies).
    `inact` is bool[N] (True sorts last) or None.  Returns (perm int32,
    s_act bool, extras): ``perm[i]`` is the row at sorted position i,
    ``s_act[i] = ~inact[perm[i]]`` and every contiguous int32 `extra` word
    is gathered by perm.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    words = list(words)
    if not words:
        raise ValueError("words_sort: at least one key word is required")
    if words[0].device.type == "cpu":
        return words_sort_plain(words, inact, extra)
    dev = words[0].device
    n = words[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"words_sort: expected CUDA tensors, got {dev}")
    _lib.check_columns("words_sort", words, n, dev)
    masks = () if inact is None else (inact,)
    for t in masks:
        _lib.check_cuda("words_sort inact", t, torch.bool, dev)
    for w in extra:
        _lib.check_cuda("words_sort extra", w, torch.int32, dev)
    if any(t.shape != (n,) for t in (*masks, *extra)):
        raise ValueError("words_sort: inact and extra words must be [N] like the key words")
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    s_act = torch.ones(n, dtype=torch.bool, device=dev)
    ex_out = tuple(torch.empty_like(w) for w in extra)
    if n == 0:
        return perm, s_act, ex_out
    lib = _lib.library()
    scratch = torch.empty(
        lib.dbt_words_sort_scratch_words(n), dtype=torch.int32, device=dev
    )
    with torch.cuda.device(dev):
        err = lib.dbt_words_sort(
            _lib.ptr_array(words), _lib.stride_array(words), len(words),
            None if inact is None else inact.data_ptr(), n,
            perm.data_ptr(), s_act.data_ptr(),
            _lib.ptr_array(extra), _lib.ptr_array(ex_out), len(extra),
            scratch.data_ptr(), _lib.stream_of(perm),
        )
    _lib.raise_on_error(err, "words_sort")
    _lib.LAUNCHES["words_sort"] += 1
    return perm, s_act, ex_out


def words_sort_plain(
    words: Sequence[torch.Tensor],
    inact: torch.Tensor | None = None,
    extra: tuple = (),
) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """The same order by stable torch.sort passes, least significant word
    first, each over the word read through the order so far."""
    n = words[0].shape[0]
    perm = torch.arange(n, device=words[0].device)
    for w in reversed(list(words)):
        perm = perm[torch.sort(as_u32(w)[perm], stable=True).indices]
    if inact is None:
        s_act = torch.ones(n, dtype=torch.bool, device=perm.device)
    else:
        perm = perm[torch.sort(inact[perm].to(torch.uint8), stable=True).indices]
        s_act = ~inact[perm]
    return perm.to(torch.int32), s_act, tuple(w[perm] for w in extra)
