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
    strided), `splitters` as many int32[S] columns (possibly strided, on the
    card: the wrapper launches K22 and nothing else), splitter s being
    ``(splitters[0][s], ..., splitters[-1][s])``.  ``dist_plan.range_plan``
    picks K22's path: 16-byte loads where every key column is contiguous
    and aligned, 4-byte loads otherwise.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Splitters past ``dist_plan.RANGE_SPLITTER_BYTES`` go in rounds of
    ``dist_plan.range_round`` (one launch each on the card), whose
    destinations are added on the device.
    """
    words, splitters = list(words), list(splitters)
    if not words or len(words) != len(splitters):
        raise ValueError("range_dest: one splitter column a key word, at least one")
    n, ns = words[0].shape[0], splitters[0].shape[0]
    per = dist_plan.range_round(len(words), ns)
    if per < ns:
        dest = range_dest(words, [s[:per] for s in splitters])
        for lo in range(per, ns, per):
            dest += range_dest(words, [s[lo:lo + per] for s in splitters])
        return dest
    dist_plan.check_splitters("range_dest", n, len(words), ns)
    if words[0].device.type == "cpu":
        return range_dest_plain(words, splitters)
    dev = words[0].device
    if dev.type != "cuda":
        raise ValueError(f"range_dest: expected CUDA tensors, got {dev}")
    _lib.check_columns("range_dest", words, n, dev)
    _lib.check_columns("range_dest splitters", splitters, ns, dev)
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return dest
    vec, blocks = dist_plan.range_plan(n, [w.data_ptr() for w in words],
                                             [w.stride(0) for w in words], dest.data_ptr())
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_range_dest(_lib.ptr_array(words), _lib.stride_array(words), len(words), n,
                                 _lib.ptr_array(splitters), _lib.stride_array(splitters), ns,
                                 dest.data_ptr(), int(vec), blocks,
                                 _lib.stream_of(words[0]))
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
