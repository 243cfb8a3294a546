"""K18: the bucket compare of the bucketed semi-join
(``csrc/bucket_probe.cu``) and its plain torch version.

Replaces the padded bucket table, the broadcast compare and the overflow
rule of the JAX package's ``_bucket_table`` and ``_bucketed_matched``
(``ops/bucket_join.py:59-158``).  The kernel's two launches, the first row
of every bucket of both sides, then a block a span of consecutive buckets,
follow ``engines_plan.bucket_plan``.
"""

from __future__ import annotations

import torch

from ..batch import as_u32
from . import _lib, engines_plan


def bucket_probe(
    b_bucket: torch.Tensor, b_key: torch.Tensor, p_bucket: torch.Tensor, p_key: torch.Tensor,
    nbuckets: int, cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both sides sorted by bucket: `b_bucket` int32[NB] and `p_bucket`
    int32[P] non-decreasing in [0, nbuckets], bucket `nbuckets` holding the
    inactive rows; `b_key`, `p_key` int32 u32 keys beside them.  A bucket
    below `nbuckets` with more than `cap` rows on either side overflows.
    Returns (hit bool[P] in the probe side's sorted order, overflow 0-d
    int32): hit is True where the row's bucket is live and does not
    overflow and one of its build keys equals the row's key; overflow
    counts the rows past `cap` of every bucket, both sides.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    starts and compare launches (after a memset of the overflow count).
    """
    nbuckets, cap = int(nbuckets), int(cap)
    engines_plan.check_buckets("bucket_probe", nbuckets, cap)
    if p_key.device.type == "cpu":
        return bucket_probe_plain(b_bucket, b_key, p_bucket, p_key, nbuckets, cap)
    dev = p_key.device
    nb, npr = b_key.shape[0], p_key.shape[0]
    for name, t, n in (("b_bucket", b_bucket, nb), ("b_key", b_key, nb),
                       ("p_bucket", p_bucket, npr), ("p_key", p_key, npr)):
        _lib.check_cuda(f"bucket_probe {name}", t, torch.int32, dev)
        if t.shape != (n,):
            raise ValueError(f"bucket_probe: {name} of shape {tuple(t.shape)}, expected ({n},)")
    engines_plan.check_rows("bucket_probe", nb, npr)
    plan = engines_plan.bucket_plan()
    hit = torch.empty(npr, dtype=torch.bool, device=dev)
    ovf = torch.empty((), dtype=torch.int32, device=dev)
    starts = torch.empty(engines_plan.bucket_starts_words(nbuckets), dtype=torch.int32,
                         device=dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_bucket_probe(
            b_bucket.data_ptr(), b_key.data_ptr(), nb, p_bucket.data_ptr(), p_key.data_ptr(),
            npr, nbuckets, cap, plan.span, plan.threads, starts.data_ptr(), hit.data_ptr(),
            ovf.data_ptr(), _lib.stream_of(p_key),
        )
    _lib.raise_on_error(err, "bucket_probe")
    _lib.LAUNCHES["bucket_probe"] += 1
    return hit, ovf


def bucket_probe_plain(
    b_bucket: torch.Tensor, b_key: torch.Tensor, p_bucket: torch.Tensor, p_key: torch.Tensor,
    nbuckets: int, cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The same result from bucket counts (``bincount``) and one
    ``torch.isin`` of (bucket, key) pairs; it needs no order."""
    bb, pb = b_bucket.long(), p_bucket.long()
    cb = torch.bincount(bb[bb < nbuckets], minlength=nbuckets)
    cp = torch.bincount(pb[pb < nbuckets], minlength=nbuckets)
    over = (cb > cap) | (cp > cap)
    ovf = ((cb - cap).clamp(min=0).sum() + (cp - cap).clamp(min=0).sum()).to(torch.int32)
    b_live = bb < nbuckets
    b_live &= ~over[bb.clamp(max=nbuckets - 1)]
    p_live = pb < nbuckets
    p_live &= ~over[pb.clamp(max=nbuckets - 1)]
    b_pairs = (bb[b_live] << 32) | as_u32(b_key[b_live])
    p_pairs = (pb << 32) | as_u32(p_key)
    return p_live & torch.isin(p_pairs, b_pairs), ovf
