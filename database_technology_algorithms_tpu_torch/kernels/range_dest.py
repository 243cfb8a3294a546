"""K22: the distributed sort's range destination (``csrc/range_dest.cu``)
and its plain torch version.

Replaces the JAX package's ``_lex_ge`` and the sum over its matrix
(``parallel/dist_ops.py:312-326,380``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import as_u32
from . import _lib, dist_plan


def range_dest(words: Sequence[torch.Tensor], splitters: Sequence[torch.Tensor]) -> torch.Tensor:
    """int32[N]: the number of splitters each row's key is greater than or
    equal to, lexicographically over the u32 words, unsigned.

    `words` are 1-4 int32[N] key columns (most significant first, possibly
    strided), `splitters` as many int32[S] columns, splitter s being
    ``(splitters[0][s], ..., splitters[-1][s])``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    words, splitters = list(words), list(splitters)
    if not words or len(words) != len(splitters):
        raise ValueError("range_dest: one splitter column a key word, at least one")
    n, ns = words[0].shape[0], splitters[0].shape[0]
    dist_plan.check_splitters("range_dest", n, len(words), ns)
    if words[0].device.type == "cpu":
        return range_dest_plain(words, splitters)
    dev = words[0].device
    if dev.type != "cuda":
        raise ValueError(f"range_dest: expected CUDA tensors, got {dev}")
    _lib.check_columns("range_dest", words, n, dev)
    for s in splitters:
        _lib.check_cuda("range_dest splitters", s, torch.int32, dev)
        if s.shape != (ns,):
            raise ValueError("range_dest: splitter columns must all be [S]")
    spl = torch.stack(splitters).contiguous()  # word-major [nw, S]
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dest
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_range_dest(_lib.ptr_array(words), _lib.stride_array(words), len(words), n,
                                 spl.data_ptr(), ns, dest.data_ptr(), _lib.stream_of(words[0]))
    _lib.raise_on_error(err, "range_dest")
    _lib.LAUNCHES["range_dest"] += 1
    return dest


def lex_ge(words: Sequence[torch.Tensor], splitters: Sequence[torch.Tensor]) -> torch.Tensor:
    """bool[N, S]: key i >= splitter s, lexicographically, unsigned (the
    JAX package's ``_lex_ge``, word by word)."""
    n, ns = words[0].shape[0], splitters[0].shape[0]
    gt = torch.zeros((n, ns), dtype=torch.bool, device=words[0].device)
    eq = torch.ones((n, ns), dtype=torch.bool, device=words[0].device)
    for w, s in zip(words, splitters):
        wv, sv = as_u32(w)[:, None], as_u32(s)[None, :]
        gt |= eq & (wv > sv)
        eq &= wv == sv
    return gt | eq


def range_dest_plain(words: Sequence[torch.Tensor],
                     splitters: Sequence[torch.Tensor]) -> torch.Tensor:
    """The JAX package's form: ``lex_ge``'s [N, S] matrix summed over the
    splitters."""
    return lex_ge(words, splitters).sum(1, dtype=torch.int32)
