"""K20 and K21: the skew join's hot-hash list and membership in it
(``csrc/hot_set.cu``), and their plain torch versions.

K20 replaces the candidate reduction of the JAX package's ``hot_hash_set``
(``parallel/skew.py:68-88``): ``hot_lists`` takes both sides of the skew
join in one launch, ``hot_hashes`` one side.  K21 replaces its
``in_hash_set`` (``parallel/skew.py:91-96``).  Past their shared-memory
limits both take a sorted form of kernels the port already has
(``dist_plan.hot_by_sort``, ``dist_plan.in_set_by_sort``), on the CPU too.
"""

from __future__ import annotations

import torch

from . import _lib, dist_plan
from .radix_sort import view_sort
from .seg_scan import seg_scan
from .sorted_probe import sorted_probe
from .unpermute import unpermute

SENTINEL = -1  # 0xFFFFFFFF as int32 bits: no hot hash


def _threshold(threshold, dev) -> torch.Tensor:
    if isinstance(threshold, torch.Tensor):
        return threshold.reshape(()).to(device=dev, dtype=torch.int32)
    return torch.full((), int(threshold), dtype=torch.int32, device=dev)


def _launch_k20(plan, gh_p, gc_p, tot_p, gh_b, gc_b, tot_b, div, hot, n_hot) -> None:
    lib = _lib.library()
    with torch.cuda.device(hot.device):
        err = lib.dbt_hot_lists(
            gh_p.data_ptr(), gc_p.data_ptr(), gh_p.shape[0], tot_p.data_ptr(),
            gh_b.data_ptr() if gh_b is not None else None,
            gc_b.data_ptr() if gc_b is not None else None,
            gh_b.shape[0] if gh_b is not None else 0,
            tot_b.data_ptr() if tot_b is not None else None, div, hot.data_ptr(),
            n_hot.data_ptr() if n_hot is not None else None, int(plan.block), plan.threads,
            plan.blocks, _lib.stream_of(hot))
    _lib.raise_on_error(err, "hot_lists")
    _lib.LAUNCHES["hot_hashes"] += 1


def hot_hashes(gh: torch.Tensor, gc: torch.Tensor, threshold) -> torch.Tensor:
    """The hot list of one side's gathered candidates.

    `gh` int32[m] holds the candidates' u32 hashes (``SENTINEL`` for none),
    `gc` int32[m] their counts, `threshold` an int or a 0-d integer tensor.
    Candidate i is hot where it is the first candidate with its hash, the
    counts of every candidate with its hash sum (int32, wrapping) above
    `threshold` (signed), and its hash is not the sentinel.  Returns
    int32[m]: the hash where hot, else ``SENTINEL``.  K20's one-sided launch.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Past ``dist_plan.HOT_MAX_CANDIDATES`` both take ``hot_hashes_sorted``.
    """
    m = gh.shape[0]
    if gc.shape != (m,):
        raise ValueError("hot_hashes: gh and gc must be [m]")
    if dist_plan.hot_by_sort(m, 0):
        return hot_hashes_sorted(gh, gc, _threshold(threshold, gh.device))
    plan = dist_plan.hot_plan(m, 0, "hot_hashes")
    if gh.device.type == "cpu":
        return hot_hashes_plain(gh, gc, threshold)
    dev = gh.device
    _lib.check_cuda("hot_hashes gh", gh, torch.int32)
    _lib.check_cuda("hot_hashes gc", gc, torch.int32, dev)
    thr = _threshold(threshold, dev)
    hot = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return hot
    _launch_k20(plan, gh, gc, thr, None, None, None, 0, hot, None)
    return hot


def hot_hashes_plain(gh: torch.Tensor, gc: torch.Tensor, threshold) -> torch.Tensor:
    """The JAX package's [m, m] equality matrix: per candidate the sum of
    the equal candidates' counts (wrapped to int32) and whether an earlier
    candidate has its hash."""
    m = gh.shape[0]
    eq = gh[:, None] == gh[None, :]
    tot = torch.where(eq, gc.long()[None, :], 0).sum(1)
    tot = ((tot + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)  # int32 wraparound
    idx = torch.arange(m, device=gh.device)
    first = ~(eq & (idx[None, :] < idx[:, None])).any(1)
    hot = first & (tot > _threshold(threshold, gh.device).long()) & (gh != SENTINEL)
    return torch.where(hot, gh, SENTINEL)


def hot_hashes_sorted(gh: torch.Tensor, gc: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """``hot_hashes`` for any number of candidates, from a sort: the
    candidates by hash, stably (K1, the gathered position breaking ties, so
    a hash's first candidate leads its run), each run's total by a reversed
    segmented sum that restarts at the run's last row (K2, wrapping as
    int32), the decision on each run's first row, and the decisions
    scattered back to the candidates' positions (K7).  `threshold` is a 0-d
    int32 tensor on the candidates' device; nothing is read back to the
    host."""
    m = gh.shape[0]
    dev = gh.device
    if m == 0:
        return gh.clone()
    s_hash, perm, _, (s_count,) = view_sort(torch.zeros(m, dtype=torch.bool, device=dev), gh,
                                            (gc,))
    change = s_hash[1:] != s_hash[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, change])
    last = torch.cat([change, one])
    tot = seg_scan(last, s_count, "add", signed=True, reverse=True)
    hot = first & (tot > threshold) & (s_hash != SENTINEL)
    return unpermute(perm, torch.where(hot, s_hash, SENTINEL))


def hot_lists(gh_p: torch.Tensor, gc_p: torch.Tensor, tot_p: torch.Tensor, gh_b: torch.Tensor,
              gc_b: torch.Tensor, tot_b: torch.Tensor,
              div: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The skew join's hot list of both sides in one launch.

    Side p (the probe side) and side b each give their gathered candidates
    (`gh_*` int32[m_*] of u32 hashes, `gc_*` int32[m_*] counts) and their
    psum'd live count `tot_*` (a 0-d int32 tensor); a side's threshold is
    ``max(tot // div, 1)`` (torch's floor division; `div` = ndev *
    hh_factor >= 1).  Returns (hot int32[m_p + m_b], n_hot int32 0-d): each
    side's ``hot_hashes`` list, side p's first, and the number of entries
    that are not ``SENTINEL``.  ``dist_plan.hot_plan`` picks K20's mode.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    m_p, m_b = gh_p.shape[0], gh_b.shape[0]
    if gc_p.shape != (m_p,) or gc_b.shape != (m_b,):
        raise ValueError("hot_lists: each side's gh and gc must be [m]")
    if int(div) < 1:
        raise ValueError(f"hot_lists: div {div} < 1")
    if dist_plan.hot_by_sort(m_p, m_b):
        hot = torch.cat([hot_hashes_sorted(h, c, (t.reshape(()) // div).clamp(min=1).to(h.device))
                         for h, c, t in ((gh_p, gc_p, tot_p), (gh_b, gc_b, tot_b))])
        return hot, (hot != SENTINEL).sum(dtype=torch.int32)
    plan = dist_plan.hot_plan(m_p, m_b)
    if gh_p.device.type == "cpu":
        return hot_lists_plain(gh_p, gc_p, tot_p, gh_b, gc_b, tot_b, div)
    dev = gh_p.device
    for name, t in (("gh_p", gh_p), ("gc_p", gc_p), ("tot_p", tot_p), ("gh_b", gh_b),
                    ("gc_b", gc_b), ("tot_b", tot_b)):
        _lib.check_cuda(f"hot_lists {name}", t, torch.int32, dev)
    if tot_p.numel() != 1 or tot_b.numel() != 1:
        raise ValueError("hot_lists: tot_p and tot_b must hold one value each")
    hot = torch.empty(m_p + m_b, dtype=torch.int32, device=dev)
    n_hot = torch.empty((), dtype=torch.int32, device=dev)
    _launch_k20(plan, gh_p, gc_p, tot_p, gh_b, gc_b, tot_b, int(div), hot, n_hot)
    return hot, n_hot


def hot_lists_plain(gh_p, gc_p, tot_p, gh_b, gc_b, tot_b,
                    div: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each side's threshold in the count's dtype, its plain hot list, the
    two lists concatenated and their live entries counted, as the JAX form
    does them one after the other."""
    hot = torch.cat([hot_hashes_plain(h, c, (t // div).clamp(min=1))
                     for h, c, t in ((gh_p, gc_p, tot_p), (gh_b, gc_b, tot_b))])
    return hot, (hot != SENTINEL).sum(dtype=torch.int32)


def in_hot_set(hashes: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """bool[N]: the row's hash equals an entry of `hot` (int32[mh] of u32
    hashes) that is not ``SENTINEL``.  ``dist_plan.in_set_plan`` picks K21's
    path (16-byte loads of an aligned column, 4-byte ones otherwise) and
    mode (the live entries scanned, or a long list sorted and searched).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Past ``dist_plan.IN_SET_MAX_HOT`` entries both take ``in_hot_set_sorted``.
    """
    n, mh = hashes.shape[0], hot.shape[0]
    if dist_plan.in_set_by_sort(mh):
        dist_plan.check_hot_list("in_hot_set", n, 0)
        return in_hot_set_sorted(hashes, hot)
    dist_plan.check_hot_list("in_hot_set", n, mh)
    if hashes.device.type == "cpu":
        return in_hot_set_plain(hashes, hot)
    dev = hashes.device
    _lib.check_cuda("in_hot_set hashes", hashes, torch.int32)
    _lib.check_cuda("in_hot_set hot", hot, torch.int32, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    plan = dist_plan.in_set_plan(n, mh, hashes.data_ptr(), out.data_ptr())
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_in_hot_set(hashes.data_ptr(), n, hot.data_ptr(), mh, out.data_ptr(),
                                 plan.rows, int(plan.vec), int(plan.search), plan.threads,
                                 plan.blocks, _lib.stream_of(hashes))
    _lib.raise_on_error(err, "in_hot_set")
    _lib.LAUNCHES["in_hot_set"] += 1
    return out


def in_hot_set_sorted(hashes: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """``in_hot_set`` for a list of any length: the list's live entries
    sorted to the front (K1 with the sentinels inactive, so they stay
    behind as ``U32_MAX``, which the probe takes as the tail) and each row's
    hash searched among them (K15, the live count on the device)."""
    live = hot != SENTINEL
    s_hot, _, _, _ = view_sort(~live, hot)
    hit, _ = sorted_probe(s_hot, live.sum(dtype=torch.int32), hashes)
    return hit


def in_hot_set_plain(hashes: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """The JAX package's broadcast compare, against the non-sentinel
    entries only (the same answer; a sentinel never matches), a slice of
    the rows at a time so that the [rows, live] matrix stays under 2^26."""
    live = hot[hot != SENTINEL]
    step = max((1 << 26) // max(live.shape[0], 1), 1)
    return torch.cat([(hashes[i:i + step, None] == live[None, :]).any(1)
                      for i in range(0, hashes.shape[0], step)]
                     + [torch.zeros(0, dtype=torch.bool, device=hashes.device)])
