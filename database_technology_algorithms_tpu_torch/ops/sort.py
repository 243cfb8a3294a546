"""Total-order key sorts over record batches.

Port of the JAX package's ``ops/sort.py``.  A key sort moves no record: it
returns a permutation, the exact adjacency mask and the caller's extra words
(``SortedView``); on the gather route one record gather (K4) then
materializes what an operator emits, on the placement route
(``materialize="sort"``/``"sort2d"``) ``ops/movement.py``'s placements do.

The JAX package packs (inact, key, row) into two u32 operands and sorts
string keys by a prefix with a ``lax.cond`` fallback to exact stable passes,
because ``lax.sort`` costs per operand there.  Here the row index is the
value a stable radix sort carries, never a key: single-word keys under an
inactivity mask go through K1 (``kernels/radix_sort.py``), every other key
through K5 (``kernels/words_sort.py``), which sorts ALL the key's words, so
it is exact for strings without a prefix pass, a tie check or a fallback
(``_lsd_exact_string_perm`` has no separate counterpart).  The row index
being the last sort key makes the order total, so either kernel gives the
JAX result bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..batch import RecordBatch, as_u32, canonical_field
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.adj_equal import adj_equal
from ..kernels.compact import compact_words
from ..kernels.radix_sort import view_sort
from ..kernels.unpermute import unpermute
from ..kernels.words_sort import words_sort
from ..utils.checks import ensure_device_budget
from .keys import key_words
from .movement import packed_placement, permute_rows, use_sort_placement
from .scan import cumsum


class SortedView(NamedTuple):
    """A key sort without row movement: ``perm`` (sorted position -> row),
    ``adj_eq`` (row equals the previous row's key) and carried extras."""

    perm: torch.Tensor
    adj_eq: torch.Tensor
    extras: tuple


def packed_u32_view_sort(inact: torch.Tensor, key: torch.Tensor, extra: tuple = ()):
    """Sort by (inact, u32 key, row index); returns (s_key, perm, s_act,
    extras) as the JAX function does (``ops/sort.py:190``)."""
    return view_sort(inact, key, extra)


def view_sort_3key(inact: torch.Tensor, key: torch.Tensor, extra: tuple = ()):
    """The same order as three sort words (``packed_u32_sorts=False``).

    On the card the radix kernel already sorts by exactly these words, so
    this form launches it too; on the CPU it is a lexicographic sort by
    stable passes, least significant word first.
    """
    if key.device.type != "cpu":
        return view_sort(inact, key, extra)
    perm = torch.sort(as_u32(key), stable=True).indices
    perm = perm[torch.sort(inact[perm].to(torch.uint8), stable=True).indices]
    return key[perm], perm.to(torch.int32), ~inact[perm], tuple(w[perm] for w in extra)


def sorted_adjacent_equal(s_key: torch.Tensor) -> torch.Tensor:
    """adj_eq of a single-word key that is already in sorted order."""
    return torch.cat([s_key.new_zeros(1, dtype=torch.bool), s_key[1:] == s_key[:-1]])


def _as_word(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.int32) if w.dtype == torch.bool else w


def sort_keys(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    pre_words: tuple = (),
    post_words: tuple = (),
    extra: tuple = (),
    pre_is_mask: bool = False,
) -> SortedView:
    """Sort rows by pre_words ++ field key ++ post_words ++ row index; exact
    for all four key domains; no record moves.

    The join and distinct operators thread an "inactive row" word through
    `pre_words` to sink padding rows.  Words are int32 tensors holding u32
    bits or bool masks.  A single pre word that is a bool mask, or is
    declared 0/1-valued by ``pre_is_mask``, costs one 1-bit pass instead of
    four digit passes; with a single-word u32 key and no post words that is
    K1's order (gated by ``cfg.packed_u32_sorts`` as in the JAX package;
    both gates give the same result).  `extra` int32 words are gathered into
    sorted order.
    """
    field = canonical_field(field)
    kw = key_words(batch, field)
    pre = list(pre_words)
    post = [_as_word(w) for w in post_words]
    extra = tuple(extra)
    inact = None
    if len(pre) == 1 and (pre_is_mask or pre[0].dtype == torch.bool):
        inact = pre[0] if pre[0].dtype == torch.bool else pre[0] != 0
        pre = []
    if inact is not None and len(kw) == 1 and not post and pre_is_mask and cfg.packed_u32_sorts:
        s_key, perm, _, extras = packed_u32_view_sort(inact, kw[0], extra)
        return SortedView(perm=perm, adj_eq=sorted_adjacent_equal(s_key), extras=extras)
    words = [_as_word(w) for w in pre] + kw + post
    perm, _, extras = words_sort(words, inact, extra)
    return SortedView(perm=perm, adj_eq=adj_equal(kw, perm), extras=extras)


def survivor_dest(view_perm: torch.Tensor, keep_sorted: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dest, count): each ORIGINAL row's output position under "kept rows,
    in sorted order, to the front; drops after, in sorted order".

    `keep_sorted` is a mask over the sorted positions of `view_perm`; dest is
    a dense permutation of [0, N) in original row order.  The ranks are one
    K2 scan; K7 hands them back to original order (the JAX package's
    un-permute sort).
    """
    n = view_perm.shape[0]
    count = keep_sorted.sum(dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=view_perm.device)
    rank = cumsum(keep_sorted) - 1
    dest_sorted = torch.where(keep_sorted, rank, count + (pos - rank - 1))
    return unpermute(view_perm, dest_sorted), count


def materialize_survivors(
    batch: RecordBatch,
    view_perm: torch.Tensor,
    keep_sorted: torch.Tensor,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor]:
    """Kept rows, in sorted order, to the front of a batch of
    ``batch.nrows`` rows; rows past the count are zero with valid False.
    Returns (batch, count).

    `keep_sorted` is a mask over the sorted positions of `view_perm`.
    `batch` holds the rows the permutation indexes, or only the leading
    ones when every kept row lies among them (the join keeps R rows of
    R||S): the output then has that many rows, as the JAX package's slice of
    the full gather has.  Gather route: one compaction (K3) and one record
    gather (K4).  Placement route: ``survivor_dest``, whose leading
    destinations stay unique, placed by ``permute_rows``.
    """
    nout = batch.nrows
    if use_sort_placement(cfg):
        dest, count = survivor_dest(view_perm, keep_sorted)
        return permute_rows(batch, dest[:nout], count=count, cfg=cfg), count
    count, (front,) = compact_words(keep_sorted, (view_perm,))
    return batch.take_fill(front[:nout], count=count), count


def sort_batch_impl(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
) -> tuple[RecordBatch, torch.Tensor]:
    """Sort a batch by `field`.  Returns (sorted_batch, perm).

    Exact for all four key domains.  With `count`, only the first `count`
    rows are live; padding sinks to the tail (static-capacity convention).
    One key sort, then one record gather, or on the placement route the
    inverse permutation (K7) placed by ``permute_rows``.
    """
    field = canonical_field(field)
    n = batch.nrows
    ensure_device_budget(n, cfg, "sort_batch")
    rows = torch.arange(n, dtype=torch.int32, device=batch.recid.device)
    if n <= 1:
        return batch, rows
    pre = () if count is None else (rows >= count,)
    view = sort_keys(batch, field, cfg, pre_words=pre, pre_is_mask=True)
    # The JAX package's fused branch (packed_placement: the u32 fields on the
    # "sort" route at 4 + K <= 8) carries the whole record through one sort
    # keyed by (inactive, key, row): the view sort and record gather below.
    if use_sort_placement(cfg) and not packed_placement(cfg, field, batch.str_words):
        # dest = the inverse permutation: each row's sorted position
        return permute_rows(batch, unpermute(view.perm, rows), cfg=cfg), view.perm
    return batch.take(view.perm), view.perm


def sort_batch(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
) -> tuple[RecordBatch, torch.Tensor]:
    """The public form: batches beyond ``cfg.mem_rows`` route through the
    chunked two-pass route (``ops/chunked.py``) instead of raising; the
    core ``sort_batch_impl`` keeps its budget gate."""
    if batch.nrows > cfg.mem_rows:
        from .chunked import sort_batch_chunked

        return sort_batch_chunked(batch, field, cfg, count)
    return sort_batch_impl(batch, field, cfg, count)


def sort_perm(batch: RecordBatch, field, cfg: EngineConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Permutation-only helper (exact for strings; no record gather)."""
    return sort_keys(batch, field, cfg).perm


def is_sorted(batch: RecordBatch, field, cfg: EngineConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """bool scalar: batch rows are in non-decreasing key order (full width)."""
    n = batch.nrows
    dev = batch.recid.device
    if n <= 1:
        return torch.ones((), dtype=torch.bool, device=dev)
    lt = torch.zeros(n - 1, dtype=torch.bool, device=dev)  # strictly less at first difference
    eq = torch.ones(n - 1, dtype=torch.bool, device=dev)
    for w in key_words(batch, field):
        u = as_u32(w)
        lt |= eq & (u[:-1] < u[1:])
        eq &= u[:-1] == u[1:]
    return (lt | eq).all()
