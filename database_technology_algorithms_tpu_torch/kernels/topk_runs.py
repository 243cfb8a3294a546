"""K19: the top-k runs of a sorted hash column (``csrc/topk_runs.cu``) and
its plain torch version.

Replaces the run counts and ``lax.top_k`` of the JAX package's
``local_topk_hashes`` (``parallel/skew.py:44-65``).
"""

from __future__ import annotations

import torch

from ..batch import as_u32
from . import _lib, dist_plan, rowmove_plan
from .compact import compact_words
from .radix_sort import view_sort


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

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch and a memset of its done counter: the tiles' top k, then, in
    the last block to finish, the top k of those; ``dist_plan``).  Past
    ``dist_plan.TOPK_MAX_K`` picks both take ``topk_runs_sorted``.
    """
    n = hs.shape[0]
    dist_plan.check_topk("topk_runs", n, k)
    if dist_plan.topk_by_sort(k):
        return topk_runs_sorted(hs, nact, k)
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


def topk_runs_sorted(hs: torch.Tensor, nact, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_runs`` for any k, from a sort of the runs: the run starts
    compacted to the front in position order, the other positions after
    them in order (K3 with the row index as payload); a run's count is the
    distance to the next start, or to `nact` for the last run, and every
    other position counts 0; a stable sort by the count descending (K1 on
    ``~count``, the compacted order breaking ties: the lower position
    first, as ``lax.top_k`` does) puts the top k first.  No count is read
    back to the host."""
    n = hs.shape[0]
    dev = hs.device
    live = rowmove_plan.live_positions(n, nact, dev)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), hs[1:] != hs[:-1]]) & live
    nruns, (pos,) = compact_words(start, (0,))
    idx = torch.arange(n, device=dev)
    nxt = torch.cat([pos[1:], pos[:1]])
    nxt = torch.where(idx + 1 < nruns, nxt, torch.as_tensor(nact, dtype=torch.int32, device=dev))
    count = torch.where(idx < nruns, nxt - pos, 0).to(torch.int32)
    _, _, _, (top_pos, top_count) = view_sort(torch.zeros(n, dtype=torch.bool, device=dev),
                                              ~count, (pos, count))
    return hs[top_pos[:k].long()], top_count[:k]
