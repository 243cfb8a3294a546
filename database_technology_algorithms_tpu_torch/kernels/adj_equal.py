"""K6: adjacent-key equality under a permutation (``csrc/adj_equal.cu``)
and its plain torch version.

Replaces the JAX package's ``rows_equal_on_field(batch, field, perm[:-1],
perm[1:])`` with its leading False (``ops/keys.py:68``, ``ops/sort.py:128``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _lib

MAX_KEY_WORDS = 40  # csrc/adj_equal.cu


def adj_equal(words: Sequence[torch.Tensor], perm: torch.Tensor | None = None) -> torch.Tensor:
    """bool[N]: sorted row i has the same key as sorted row i-1 on every
    word (element 0 is False).  `words` are int32[N] columns, possibly
    strided; `perm` is int32[N] (sorted position -> row), or None to compare
    the rows in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    words = list(words)
    if not words:
        raise ValueError("adj_equal: at least one key word is required")
    if words[0].device.type == "cpu":
        return adj_equal_plain(words, perm)
    dev = words[0].device
    n = words[0].shape[0]
    if dev.type != "cuda":
        raise ValueError(f"adj_equal: expected CUDA tensors, got {dev}")
    if len(words) > MAX_KEY_WORDS:
        raise ValueError(f"adj_equal: {len(words)} key words, at most {MAX_KEY_WORDS}")
    _lib.check_columns("adj_equal", words, n, dev)
    if perm is not None:
        _lib.check_cuda("adj_equal perm", perm, torch.int32, dev)
        if perm.shape != (n,):
            raise ValueError("adj_equal: perm must be [N] like the key words")
    adj = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return adj
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_adj_equal(
            _lib.ptr_array(words), _lib.stride_array(words), len(words),
            None if perm is None else perm.data_ptr(), n, adj.data_ptr(),
            _lib.stream_of(adj),
        )
    _lib.raise_on_error(err, "adj_equal")
    _lib.LAUNCHES["adj_equal"] += 1
    return adj


def adj_equal_plain(
    words: Sequence[torch.Tensor], perm: torch.Tensor | None = None
) -> torch.Tensor:
    """The same mask by gathering each word through perm and comparing
    neighbours."""
    n = words[0].shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=words[0].device)
    eq = torch.ones(n - 1, dtype=torch.bool, device=words[0].device)
    for w in words:
        ws = w if perm is None else w[perm.long()]
        eq &= ws[1:] == ws[:-1]
    return torch.cat([eq.new_zeros(1), eq])
