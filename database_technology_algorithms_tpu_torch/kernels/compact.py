"""K3: stable compaction (``csrc/compact.cu``) and its plain torch version.

Replaces the JAX package's ``compact_words`` (``ops/movement.py:479``).
"""

from __future__ import annotations

import torch

from . import _lib
from .seg_scan import seg_scan


def compact_words(
    keep: torch.Tensor, payload: tuple
) -> tuple[torch.Tensor, tuple]:
    """Rows with `keep` True to the front, in order, then the others, in
    order, for every int32 word of `payload`.  Returns (count as a 0-d int32
    tensor, the moved words).

    CPU tensors take the plain version.  On CUDA the kept-row ranks come from
    K2 (an add scan over `keep`) and one kernel launch scatters the words.
    """
    if keep.device.type == "cpu":
        return compact_words_plain(keep, payload)
    dev = keep.device
    n = keep.shape[0]
    _lib.check_cuda("compact_words keep", keep, torch.bool)
    for w in payload:
        _lib.check_cuda("compact_words payload", w, torch.int32, dev)
        if w.shape != (n,):
            raise ValueError("compact_words: payload words must be [N] like keep")
    outs = tuple(torch.empty_like(w) for w in payload)
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=dev), outs
    incl = seg_scan(None, keep.to(torch.int32), "add")
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_compact_scatter(
            keep.data_ptr(), incl.data_ptr(), n,
            _lib.ptr_array(payload), _lib.ptr_array(outs), len(payload),
            _lib.stream_of(keep),
        )
    _lib.raise_on_error(err, "compact_words")
    _lib.LAUNCHES["compact"] += 1
    return incl[-1], outs


def compact_words_plain(
    keep: torch.Tensor, payload: tuple
) -> tuple[torch.Tensor, tuple]:
    """The same compaction as one stable torch.sort of the drop flag."""
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return keep.sum(dtype=torch.int32), tuple(w[order] for w in payload)
