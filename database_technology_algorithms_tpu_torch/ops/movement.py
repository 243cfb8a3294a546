"""Word-level data movement.

Port of the JAX package's ``ops/movement.py``, both routes.  The JAX
package moves rows through placement sorts on the TPU, where it found
random gathers slow (``materialize="sort"``/``"sort2d"``), and through a
compaction plus one record gather elsewhere (``"gather"``; ``"auto"`` picks
it off the TPU, so on every torch device).  On the gather route
``compact_words`` is kernel K3 and the record gather K4.

The placement route keeps the JAX contract: a row moves to the RANK of its
destination among all destinations (unique u32 values of any spread), and
positions at or past a live count are zero.  On the card a rank order is one
K1 view sort of the destinations (no inactive rows); whole records then move
by one K4 gather, word lists by one K12 gather of the words stacked as
[N, W].  A scatter ``out[dest[i]] = row i`` would be wrong for a sparse
``dest``.  ``packed_keep_backsort`` is K7.  ``stage_to_cells`` and
``value_boundaries``, the partition pass of the tiled over-budget join, are
kernel K9 (``kernels/stage_cells.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.compact import compact_words
from ..kernels.radix_sort import view_sort
from ..kernels.row_move import row_move
from ..kernels.stage_cells import stage_to_cells, value_boundaries
from ..kernels.unpermute import unpermute
from ..kernels.words_sort import words_sort
from .scan import cumsum

__all__ = [
    "compact_words", "compaction_dest", "compact_rows", "use_sort_placement",
    "packed_placement", "place_words", "place_words_2d", "place_group", "place_grouped",
    "place_batch", "place_join_by_key", "packed_keep_backsort", "permute_rows", "sort_words",
    "stage_to_cells", "value_boundaries",
]


def use_sort_placement(cfg: EngineConfig = DEFAULT_CONFIG) -> bool:
    """The row-movement engine: True for the placement routes "sort" and
    "sort2d", False (the gather route) for "gather" and "auto" on every torch
    device ("auto" is a test for a TPU in the JAX package)."""
    if cfg.materialize in ("sort", "sort2d"):
        return True
    if cfg.materialize in ("gather", "auto"):
        return False
    raise ValueError(f"unknown materialize engine: {cfg.materialize!r}")


def packed_placement(cfg: EngineConfig, field: int, str_words: int) -> bool:
    """The JAX package's gate for the placements of the u32 fields that
    need no destination permutation (the fused sort of ``sort_batch``,
    ``place_join_by_key`` in distinct, the join and the staged pipeline):
    the "sort" route with packed sorts and 4 + K <= 8 sort operands.  The
    callers add their own row limit where the JAX package has one."""
    return (field in (0, 1) and cfg.packed_u32_sorts and use_sort_placement(cfg)
            and cfg.materialize != "sort2d" and 4 + str_words <= 8)


def _rank_slots(dest: torch.Tensor) -> torch.Tensor:
    """Per output position, the row placed there: rows in ascending u32
    order of `dest` (K1).  The movers zero the positions at or past a live
    count themselves (their `count` argument)."""
    inact = torch.zeros(dest.shape[0], dtype=torch.bool, device=dest.device)
    return view_sort(inact, dest)[1]


def _place(dest: torch.Tensor, cnt, words) -> list[torch.Tensor]:
    """The words placed by rank of `dest`, positions >= cnt zeroed (None:
    none): one rank sort for every word, one K12 gather of the words as
    [N, W]."""
    if not words:
        return []
    n = dest.shape[0]
    stacked = torch.stack([w.to(torch.int32) for w in words], dim=1)
    moved = row_move(stacked, _rank_slots(dest), max(n, 1), load=True, count=cnt)
    return list(moved.t().contiguous())


def place_words(dest: torch.Tensor, words) -> list[torch.Tensor]:
    """``out[rank(dest[i])] = words[:][i]``: `dest` holds unique u32 values
    (int32 bits) of any spread, so a dense permutation places row i at
    dest[i]."""
    return _place(dest, None, list(words))


def place_words_2d(dest: torch.Tensor, cnt, words, npay: int = 1) -> tuple:
    """The function of ``place_words`` with rows placed at or past `cnt`
    zeroed (None: none).  The JAX package computes it as one replicated-key
    2-D sort split into `npay` matrices; on the card one rank sort serves
    every column, so the replicated key has no counterpart and `npay` changes
    nothing."""
    return tuple(_place(dest, cnt, list(words)))


def place_group(dest: torch.Tensor, cnt, *words) -> tuple:
    """One placement group with live-count zeroing.  The JAX package limits
    a group to 7 words, a compile-time bound of its sort; here a group may
    hold any number of words."""
    return tuple(_place(dest, cnt, list(words)))


def place_grouped(dest: torch.Tensor, cnt, words) -> list[torch.Tensor]:
    """``place_group`` semantics over any number of words (one group)."""
    return _place(dest, cnt, list(words))


def place_batch(dest: torch.Tensor, cnt, batch: RecordBatch) -> RecordBatch:
    """Whole-record placement: row i to the rank of ``dest[i]``, rows placed
    at or past `cnt` zero with valid False (None: every row kept).  One rank
    sort (K1) and one record gather (K4), which carries valid as the JAX
    package's fold of valid into the key's low bit does."""
    return batch.take_fill(_rank_slots(dest), count=cnt)


def place_join_by_key(
    matched: torch.Tensor,
    key: torch.Tensor,
    cnt,
    batch: RecordBatch,
    key_plane: str = "none",
) -> RecordBatch:
    """The matched rows of `batch` first, in (key, row) order, without a
    destination permutation; rows past `cnt` zero.  ``matched`` and ``key``
    are per row of `batch`, in its order; the matched rows' keys are unique,
    as in every caller (the JAX sort orders equal keys by the row's valid
    flag, then its index).

    One K1 view sort of (~matched, key) and one K4 gather with the live count
    `cnt`; each live row keeps its original valid.  With ``key_plane``
    "recid" or "num" that column is K1's sorted key, as the JAX package
    rebuilds it from its sort words."""
    s_key, perm, _, _ = view_sort(~matched, key)
    out = batch.take_fill(perm, count=cnt)
    if key_plane in ("recid", "num"):
        live = torch.arange(batch.nrows, dtype=torch.int32, device=key.device) < cnt
        out = dataclasses.replace(out, **{key_plane: torch.where(live, s_key, 0)})
    return out


def packed_keep_backsort(perm: torch.Tensor, keep: torch.Tensor, n_front: int) -> torch.Tensor:
    """A keep mask over sorted positions, returned in original row order for
    the first ``n_front`` rows: ``out[perm[i]] = keep[i]`` (K7; the JAX
    package sorts ``perm<<1 | keep``)."""
    return unpermute(perm, keep, 0, n_front)


def permute_rows(
    batch: RecordBatch,
    dest: torch.Tensor,
    count=None,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> RecordBatch:
    """Move row i to output position rank-of(dest[i]); dest values unique.
    With `count`, rows placed at or past count are zero.  "sort2d" moves the
    payload words (``place_words_2d``, K12), the other engines whole records
    (``place_batch``, K4)."""
    if cfg.materialize == "sort2d":
        return RecordBatch.from_payload_words(
            list(place_words_2d(dest, count, batch.payload_words())))
    return place_batch(dest, count, batch)


def sort_words(key_words, payload: tuple = (), stable_iota: bool = True) -> tuple[tuple, tuple]:
    """Sort rows by the u32 key words (most significant first) carrying
    int32 payload words; returns (sorted key words, sorted payload).  One K5
    launch, which gathers both.  K5 breaks ties by the row index, the order
    ``stable_iota=True`` asks for; without it the JAX package leaves ties in
    no set order, so the two agree wherever it is used, on unique keys."""
    keys = [w.to(torch.int32) if w.dtype == torch.bool else w for w in key_words]
    _, _, out = words_sort(keys, None, tuple(w.contiguous() for w in keys) + tuple(payload))
    return tuple(out[: len(keys)]), tuple(out[len(keys):])


def compaction_dest(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dest, count): dest[i] = survivor rank if kept, else count + drop rank.

    dest is a dense permutation of [0, N): survivors to the front in order,
    drops after in order.
    """
    n = keep.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=keep.device)
    ranks = cumsum(keep) - 1  # kept rank at kept rows
    count = keep.sum(dtype=torch.int32)
    return torch.where(keep, ranks, count + (iota - ranks - 1)), count


def compact_rows(
    batch: RecordBatch,
    keep: torch.Tensor,
    extra: tuple = (),
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor, tuple]:
    """Keep-masked rows to the front, order preserved; rows past `count`
    are zero with valid False.  Returns (batch, count, extras compacted
    alongside).  Gather route: one word compaction (K3) and one record
    gather (K4); placement route: ``compaction_dest`` placed by
    ``permute_rows``, the extras by ``place_words``."""
    if use_sort_placement(cfg):
        dest, count = compaction_dest(keep)
        out = permute_rows(batch, dest, count=count, cfg=cfg)
        return out, count, tuple(place_words(dest, extra)) if extra else ()
    count, out = compact_words(keep, (0, *extra))  # slot 0: the row index
    return batch.take_fill(out[0], count=count), count, out[1:]
