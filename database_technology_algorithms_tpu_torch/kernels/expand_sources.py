"""K14: the expansion sources (``csrc/expand_sources.cu``) and its plain
torch version.

Replaces the source search of the JAX package's
``materialize_field3_device`` (``ops/hash_join.py:682-686``).  The kernel
merges the output positions with ``c`` (a merge path; ``scan_plan.expand_plan``
holds its block, its items a thread and its grid).
"""

from __future__ import annotations

import torch

from . import _lib, scan_plan


def expand_sources(c: torch.Tensor, total: torch.Tensor, cap: int) -> torch.Tensor:
    """Each output row's source row in a segmented expansion: for ``i <
    min(total, cap)``, ``src[i]`` is the first j with ``c[j] > i``
    (``searchsorted(c, i, 'right')``); every other row gets ``nprobe``, the
    fill row.  `c` is the inclusive int32 cumsum of the multiplicities
    ([nprobe], non-negative), `total` a 0-d int32 tensor (``c[-1]``, or 0
    for no probe rows).  Returns int32[cap].

    The kernel reads no total: ``c[-1]`` is the total, so the count of
    entries ``c[j] <= i`` is already nprobe past it.  A `total` other than
    ``c[-1]`` (or 0 for no probe rows) is not supported: the kernel would
    still fill from ``c[-1]`` on, where the plain version fills from `total`.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"expand_sources: cap {cap} < 0")
    if c.device.type == "cpu":
        return expand_sources_plain(c, total, cap)
    dev = c.device
    _lib.check_cuda("expand_sources c", c, torch.int32)
    _lib.check_cuda("expand_sources total", total, torch.int32, dev)
    if c.dim() != 1 or total.numel() != 1:
        raise ValueError("expand_sources: c must be [nprobe] and total hold one value")
    nprobe = c.shape[0]
    plan = scan_plan.expand_plan(cap, nprobe)
    src = torch.empty(cap, dtype=torch.int32, device=dev)
    if cap == 0:
        return src
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_expand_sources(c.data_ptr(), nprobe, cap, src.data_ptr(), plan.threads,
                                     plan.items, plan.blocks, _lib.stream_of(c))
    _lib.raise_on_error(err, "expand_sources")
    _lib.LAUNCHES["expand_sources"] += 1
    return src


def expand_sources_plain(c: torch.Tensor, total: torch.Tensor, cap: int) -> torch.Tensor:
    """The JAX package's form: a right-side ``torch.searchsorted`` of every
    output position, the fill past the total."""
    i = torch.arange(int(cap), dtype=torch.int32, device=c.device)
    src = torch.searchsorted(c, i, right=True).to(torch.int32)
    return torch.where(i < total, src, c.shape[0])
