"""Bucketed build/probe semi-join for u32 keys (the Grace-hash analogue).

Port of the JAX package's ``ops/bucket_join.py``.  Both key sets are
hash-partitioned into B buckets and each probe key is compared only with
its bucket's build keys (``cfg.u32_join_engine = "bucketed"``).  The JAX
package stages each side into a padded [B, cap] table by placement sorts
and compares them by one broadcast; here K8 hashes the keys, K1 sorts each
side by (inactive, bucket, row) carrying the key, K18 finds each bucket's
range on both sides by a binary search of the sorted bucket column and
compares within it, and K7 returns the hits to probe order.  Nothing of
size [B, cap, cap] is built.

Exactness: a bucket with more than ``cap`` rows on either side (the JAX
rule; counts are about Binomial(n, 1/B), so only adversarial keys reach it)
is counted, the count is read on the host once, and a call that overflowed
takes the generic engine (``build_key_multiset`` + ``probe_multiplicity``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..batch import RecordBatch, canonical_field
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.bucket_probe import bucket_probe
from ..kernels.hash_words import hash_words
from ..kernels.unpermute import unpermute
from .sort import packed_u32_view_sort

# mean build keys per bucket; cap = _BUCKET_SLACK * mean (power of two)
_TARGET_MEAN = 16
_BUCKET_SLACK = 8


def _bucket_layout(n_rows: int) -> tuple[int, int, int]:
    """Bucket count/capacity for the LARGER side: sizing from build alone
    guarantees probe-side overflow (and a silent always-fallback engine)
    whenever mean probe keys per bucket = _TARGET_MEAN * n_probe / n_build
    exceeds the capacity, so callers pass max(n_build, n_probe)."""
    b = 1
    while b * _TARGET_MEAN < max(n_rows, 1):
        b *= 2
    cap_b = _BUCKET_SLACK * _TARGET_MEAN
    return b, cap_b, b * cap_b


def _bucket_table(
    key: torch.Tensor, active: torch.Tensor, nbuckets: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One side in bucket-major order: (bucket, key, perm) sorted by
    (inactive, bucket, row), inactive rows in bucket `nbuckets` at the tail,
    so the bucket column is non-decreasing.  K8, then K1 carrying the key."""
    bucket = torch.where(active, hash_words([key]) & (nbuckets - 1), nbuckets)
    s_bucket, perm, _, (s_key,) = packed_u32_view_sort(~active, bucket, (key,))
    return s_bucket, s_key, perm


def _bucketed_matched(
    bkey: torch.Tensor,
    b_active: torch.Tensor,
    pkey: torch.Tensor,
    p_active: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(matched bool[P] in probe order, overflow count)."""
    npr = pkey.shape[0]
    nbuckets, cap_b, _ = _bucket_layout(max(int(bkey.shape[0]), npr))
    b_bucket, b_key, _ = _bucket_table(bkey, b_active, nbuckets)
    p_bucket, p_key, p_perm = _bucket_table(pkey, p_active, nbuckets)
    # the same slack model on the probe side: cap_p = cap_b
    hit, ovf = bucket_probe(b_bucket, b_key, p_bucket, p_key, nbuckets, cap_b)
    # inactive probe rows sit in bucket nbuckets and have no hit
    return unpermute(p_perm, hit), ovf


def hash_join_count_bucketed(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    build_count=None,
    probe_count=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Engine entry: same contract as hash_join_count_impl (fields 0/1)."""
    field = canonical_field(field)
    assert field in (0, 1), "bucketed engine covers u32 key fields"
    nb, npr = build.nrows, probe.nrows
    bkey = build.recid if field == 0 else build.num
    pkey = probe.recid if field == 0 else probe.num
    dev = bkey.device
    # engine convention (shared with generic/searchsorted/table): `count`
    # marks live rows; the valid flag is the filter stage's business
    b_active = torch.ones(nb, dtype=torch.bool, device=dev)
    if build_count is not None:
        b_active = torch.arange(nb, dtype=torch.int32, device=dev) < build_count
    p_active = torch.ones(npr, dtype=torch.bool, device=dev)
    if probe_count is not None:
        p_active = torch.arange(npr, dtype=torch.int32, device=dev) < probe_count

    matched, ovf = _bucketed_matched(bkey, b_active, pkey, p_active)
    if int(ovf) > 0:
        # adversarial bucket overflow: exactness first, the generic engine
        from .hash_join import build_key_multiset, probe_multiplicity

        gcfg = dataclasses.replace(cfg, u32_join_engine="generic")
        uniq, counts, n_build = build_key_multiset(build, field, gcfg, count=build_count)
        matched, _ = probe_multiplicity(uniq, counts, n_build, probe, field, gcfg,
                                        probe_count=probe_count)
    mult = matched.to(torch.int32)
    return matched, mult, mult.sum(dtype=torch.int32)
