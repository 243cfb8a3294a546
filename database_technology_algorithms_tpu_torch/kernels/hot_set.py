"""K20 and K21: the skew join's hot-hash list and membership in it
(``csrc/hot_set.cu``), and their plain torch versions.

K20 replaces the candidate reduction of the JAX package's ``hot_hash_set``
(``parallel/skew.py:68-88``), K21 its ``in_hash_set``
(``parallel/skew.py:91-96``).
"""

from __future__ import annotations

import torch

from . import _lib, dist_plan

SENTINEL = -1  # 0xFFFFFFFF as int32 bits: no hot hash


def _threshold(threshold, dev) -> torch.Tensor:
    if isinstance(threshold, torch.Tensor):
        return threshold.reshape(()).to(device=dev, dtype=torch.int32)
    return torch.full((), int(threshold), dtype=torch.int32, device=dev)


def hot_hashes(gh: torch.Tensor, gc: torch.Tensor, threshold) -> torch.Tensor:
    """The hot list of the gathered candidates.

    `gh` int32[m] holds the candidates' u32 hashes (``SENTINEL`` for none),
    `gc` int32[m] their counts, `threshold` an int or a 0-d integer tensor.
    Candidate i is hot where it is the first candidate with its hash, the
    counts of every candidate with its hash sum (int32, wrapping) above
    `threshold` (signed), and its hash is not the sentinel.  Returns
    int32[m]: the hash where hot, else ``SENTINEL``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    m = gh.shape[0]
    if gc.shape != (m,):
        raise ValueError("hot_hashes: gh and gc must be [m]")
    dist_plan.check_candidates("hot_hashes", m)
    if gh.device.type == "cpu":
        return hot_hashes_plain(gh, gc, threshold)
    dev = gh.device
    _lib.check_cuda("hot_hashes gh", gh, torch.int32)
    _lib.check_cuda("hot_hashes gc", gc, torch.int32, dev)
    thr = _threshold(threshold, dev)
    hot = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return hot
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_hot_hashes(gh.data_ptr(), gc.data_ptr(), m, thr.data_ptr(), hot.data_ptr(),
                                 _lib.stream_of(gh))
    _lib.raise_on_error(err, "hot_hashes")
    _lib.LAUNCHES["hot_hashes"] += 1
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


def in_hot_set(hashes: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """bool[N]: the row's hash equals an entry of `hot` (int32[mh] of u32
    hashes) that is not ``SENTINEL``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    n, mh = hashes.shape[0], hot.shape[0]
    dist_plan.check_hot_list("in_hot_set", n, mh)
    if hashes.device.type == "cpu":
        return in_hot_set_plain(hashes, hot)
    dev = hashes.device
    _lib.check_cuda("in_hot_set hashes", hashes, torch.int32)
    _lib.check_cuda("in_hot_set hot", hot, torch.int32, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_in_hot_set(hashes.data_ptr(), n, hot.data_ptr(), mh, out.data_ptr(),
                                 _lib.stream_of(hashes))
    _lib.raise_on_error(err, "in_hot_set")
    _lib.LAUNCHES["in_hot_set"] += 1
    return out


def in_hot_set_plain(hashes: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """The JAX package's broadcast compare, against the non-sentinel
    entries only (the same answer; a sentinel never matches)."""
    live = hot[hot != SENTINEL]
    return (hashes[:, None] == live[None, :]).any(1)
