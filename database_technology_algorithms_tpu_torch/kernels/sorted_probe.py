"""K15: the sorted-key probe (``csrc/sorted_probe.cu``) and its plain torch
version.

Replaces the probe of the JAX package's ``hash_join_count_u32``
(``ops/fastpath.py:101-104``).  The kernel's two launches, an index of every
S-th live build key as a search tree, then a persistent grid that holds the
tree in shared memory and searches at most S - 1 keys in device memory a
probe row, follow ``engines_plan.probe_plan``.
"""

from __future__ import annotations

import torch

from ..batch import as_u32
from . import _lib, engines_plan, rowmove_plan


def sorted_probe(
    skey: torch.Tensor, build_count, pkey: torch.Tensor, probe_count=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership of each probe key in the live build keys.

    `skey` is int32[NB] holding u32 keys sorted (unsigned) over the first
    `build_count` rows (None: all NB), the rest ``U32_MAX``
    (``fastpath.masked_sorted_key``); `pkey` int32[P], its first
    `probe_count` rows live (None: all).  A count is an int or a 0-d integer
    tensor on the device.  Returns (hit bool[P], mult int32[P]): hit is True
    where the row is live and its key equals a live build key.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    index and search launches (``engines_plan.probe_plan``).
    """
    if pkey.device.type == "cpu":
        return sorted_probe_plain(skey, build_count, pkey, probe_count)
    dev = pkey.device
    _lib.check_cuda("sorted_probe pkey", pkey, torch.int32)
    _lib.check_cuda("sorted_probe skey", skey, torch.int32, dev)
    if skey.dim() != 1 or pkey.dim() != 1:
        raise ValueError("sorted_probe: skey and pkey must be 1-D")
    nb, npr = skey.shape[0], pkey.shape[0]
    engines_plan.check_rows("sorted_probe", npr)
    plan = engines_plan.probe_plan(nb)
    hit = torch.empty(npr, dtype=torch.bool, device=dev)
    mult = torch.empty(npr, dtype=torch.int32, device=dev)
    if npr == 0:
        return hit, mult
    bcnt, bcnt_host = rowmove_plan.count_arg(build_count, nb, dev)
    pcnt, pcnt_host = rowmove_plan.count_arg(probe_count, npr, dev)
    tree = torch.empty(1 << plan.levels, dtype=torch.int32, device=dev)
    blocks = engines_plan.probe_grid(
        npr, plan, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_sorted_probe(
            skey.data_ptr(), nb, None if bcnt is None else bcnt.data_ptr(), bcnt_host,
            pkey.data_ptr(), npr, None if pcnt is None else pcnt.data_ptr(), pcnt_host,
            tree.data_ptr(), plan.levels, plan.threads, blocks,
            hit.data_ptr(), mult.data_ptr(), _lib.stream_of(pkey),
        )
    _lib.raise_on_error(err, "sorted_probe")
    _lib.LAUNCHES["sorted_probe"] += 1
    return hit, mult


def sorted_probe_plain(
    skey: torch.Tensor, build_count, pkey: torch.Tensor, probe_count=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's form: a left ``torch.searchsorted`` over the whole
    masked array in the unsigned order, the take clipped to the last row,
    and the gates ``pos < build_count`` and ``row < probe_count``."""
    nb, npr = skey.shape[0], pkey.shape[0]
    count = nb if build_count is None else build_count
    if nb == 0:
        hit = torch.zeros(npr, dtype=torch.bool, device=pkey.device)
    else:
        s, p = as_u32(skey), as_u32(pkey)
        pos = torch.searchsorted(s, p)
        hit = (pos < count) & (s[pos.clamp(max=nb - 1)] == p)
    if probe_count is not None:
        hit &= rowmove_plan.live_positions(npr, probe_count, pkey.device)
    return hit, hit.to(torch.int32)
