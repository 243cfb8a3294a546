"""K19: the top-k runs of a sorted hash column (``csrc/topk_runs.cu``) and
its plain torch version.

Replaces the run counts and ``lax.top_k`` of the JAX package's
``local_topk_hashes`` (``parallel/skew.py:44-65``).
"""

from __future__ import annotations

import torch

from ..batch import as_u32
from . import _lib, dist_plan, rowmove_plan


def topk_runs(hs: torch.Tensor, nact, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k longest runs of equal values in ``hs[:nact]``.

    `hs` is int32[N] holding u32 values sorted unsigned over its first
    `nact` rows (an int or a 0-d integer tensor on the device); the rows
    past it are not read as part of any run.  Position i counts the length
    of the run it starts, 0 where it starts none (or lies at or past
    `nact`).  Returns (hash int32[k], count int32[k]): the hashes at the k
    positions of largest count in ``lax.top_k``'s order (count descending,
    the lower position first on ties) and their counts; with fewer than k
    runs the zero-count positions follow, lowest first.  1 <= k <= N.

    CPU tensors take the plain version; CUDA tensors launch the kernel (two
    passes: the tiles' top k, then the top k of those).
    """
    n = hs.shape[0]
    dist_plan.check_topk("topk_runs", n, k)
    if hs.device.type == "cpu":
        return topk_runs_plain(hs, nact, k)
    dev = hs.device
    _lib.check_cuda("topk_runs hs", hs, torch.int32)
    if hs.dim() != 1:
        raise ValueError("topk_runs: hs must be [N]")
    cnt, cnt_host = rowmove_plan.count_arg(nact, n, dev)
    if cnt is None:
        cnt = torch.full((), cnt_host, dtype=torch.int32, device=dev)
    top_hash = torch.empty(k, dtype=torch.int32, device=dev)
    top_count = torch.empty(k, dtype=torch.int32, device=dev)
    words = dist_plan.topk_scratch_words(n, k)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_topk_runs(hs.data_ptr(), n, cnt.data_ptr(), k, top_hash.data_ptr(),
                                top_count.data_ptr(), scratch.data_ptr(), words,
                                _lib.stream_of(hs))
    _lib.raise_on_error(err, "topk_runs")
    _lib.LAUNCHES["topk_runs"] += 1
    return top_hash, top_count


def topk_runs_plain(hs: torch.Tensor, nact, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's form: run starts, run counts by a segment sum, and
    the k largest by a stable descending sort (equal counts keep their
    positions' order, as ``lax.top_k`` does)."""
    n = hs.shape[0]
    live = rowmove_plan.live_positions(n, nact, hs.device)
    u = as_u32(hs)
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=hs.device), u[1:] != u[:-1]])
    new_run &= live
    seg = (torch.cumsum(new_run, 0) - 1).clamp(min=0)
    counts = torch.zeros(n, dtype=torch.int64, device=hs.device).index_add_(0, seg, live.long())
    run_counts = torch.where(new_run, counts[seg], 0)
    order = torch.sort(run_counts, descending=True, stable=True).indices[:k]
    return hs[order], run_counts[order].to(torch.int32)
