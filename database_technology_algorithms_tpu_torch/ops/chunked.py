"""Over-budget library routing: host-driven chunked device passes.

Port of the JAX package's ``ops/chunked.py``.  The reference never refuses
an oversized input: operators beyond the ``nmem_blocks`` budget go external
(``DatabaseProject.cpp:172-381``).  A device-resident batch beyond
``cfg.mem_rows`` runs a two-pass distribution sort over (activity, key
words, row index) only:

  pass 1: device-sort ``mem_rows`` chunks by (inactive, key, row) (K1 or K5
          with K6), gather the sorted key words (K4) and spill the sorted
          key matrix and row indices to host RAM;
  pass 2: sample splitters on the host, then order each budget-sized key
          range with one more device sort (K5, which also gathers the key
          columns and row indices); a worklist re-splits the ranges a
          splitter missed.

Record materialization goes through budget-sized ``take_fill`` gathers (K4).
Host RAM is the spill tier of the sorted chunks; every device program
touches O(mem_rows) rows.  A spill from the card lands in page-locked host
memory, and a range goes back up from a page-locked staging buffer, so both
copies run at the bus rate rather than at the rate of a pageable copy.  Where the JAX package brings each ordered range
back to the host and finishes there with numpy, the port leaves the range on
the device as a piece of at most mem_rows rows: DISTINCT finds the group
heads with K6 and compacts them with K3, and only row indices (the n-row
permutation or the survivors, the caller's residency like the n-row input
and output batches) are kept across pieces.  The gathered record chunks stay
on the device too and are concatenated there into the output batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.adj_equal import adj_equal
from ..kernels.words_sort import words_sort
from .keys import key_words
from .movement import compact_words, use_sort_placement
from .sort import sort_keys


def _searchsorted_rows(sorted_words: np.ndarray, split: np.ndarray, side: str) -> int:
    """Binary search a row `split` in a lexicographically sorted word matrix
    (the port's copy of the JAX package's ``external._searchsorted_rows``)."""
    lo, hi = 0, len(sorted_words)
    s = tuple(split)
    while lo < hi:
        mid = (lo + hi) // 2
        t = tuple(sorted_words[mid])
        if t < s or (side == "right" and t == s):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _spill(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host array (the spill tier).  From the card the
    copy lands in page-locked memory, which the array keeps alive."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def _staging(shape, device) -> torch.Tensor:
    """An int32 host buffer for an upload, page-locked when it goes to the card."""
    return torch.empty(shape, dtype=torch.int32, pin_memory=device.type == "cuda")


def _sorted_chunk(batch, field, cfg, lo, hi, count, active=None):
    """Device-sort rows [lo, hi) by (inactive, key, global index).

    Returns host ``(mat, gidx)``: ``mat`` is the [m, 1 + nw] u32 matrix
    (column 0 = inactivity, then the full key words) in sorted order,
    ``gidx`` (int32) the rows' original global indices in that order.
    `active` is an optional liveness mask over the whole batch, composed
    with the count convention: rows failing either sink as inactive.
    """
    sub = batch.slice(lo, hi - lo)
    dev = batch.recid.device
    gidx = torch.arange(lo, hi, dtype=torch.int32, device=dev)
    inactive = gidx >= (batch.nrows if count is None else count)
    if active is not None:
        inactive = inactive | ~active[lo:hi]
    view = sort_keys(sub, field, cfg, pre_words=(inactive,),
                     extra=(gidx, inactive.to(torch.int32)), pre_is_mask=True)
    s_gidx, s_inact = view.extras
    words = [s_inact] + [w.contiguous() for w in key_words(sub.take(view.perm), field)]
    return _spill(torch.stack(words, dim=1)).view(np.uint32), _spill(s_gidx)


def _piece_to_device(slices: list, device):
    """Host (mat, gidx) slices, concatenated in order, as a device piece: the
    matrix's columns as contiguous int32 words, and the row indices."""
    total = sum(len(g) for _, g in slices)
    mat = _staging((total, slices[0][0].shape[1]), device)
    gidx = _staging((total,), device)
    np.concatenate([m for m, _ in slices], out=mat.numpy().view(np.uint32))
    np.concatenate([g for _, g in slices], out=gidx.numpy())
    return list(mat.to(device).t().contiguous()), gidx.to(device)


def _sorted_range(slices: list, device):
    """The range's rows in (mat columns, gidx) order, as a device piece.

    The rows arrive as slices of the sorted chunks, in chunk order; each
    slice is sorted by (mat columns, gidx) and the chunks hold ascending
    blocks of the index space, so among equal mat rows the arrival order is
    gidx order already.  K5 breaks ties by arrival order, so sorting by the
    mat columns alone gives the (mat columns, gidx) order; the kernel gathers
    the columns and the indices into that order itself."""
    cols, g = _piece_to_device(slices, device)
    _, _, ordered = words_sort(cols[1:], cols[0] != 0, extra=(g, *cols))
    return list(ordered[1:]), ordered[0]


def _global_key_order(batch, field, cfg, mem_rows, count=None, active=None):
    """Yield device pieces ``(cols, gidx)`` in global (active first, key,
    index) order, each of at most mem_rows rows: ``cols`` are the inactivity
    word and the key words as int32 columns, ``gidx`` the rows' original
    indices (the key-only two-pass distribution sort; record payloads never
    move here)."""
    n = batch.nrows
    m = max(int(mem_rows), 1)
    chunks = []
    samples = []
    sample_every = max(m // 256, 1)
    for lo in range(0, n, m):
        hi = min(lo + m, n)
        mat, gidx = _sorted_chunk(batch, field, cfg, lo, hi, count, active)
        chunks.append((mat, gidx))
        samples.append(mat[::sample_every])
    device = batch.recid.device
    if not chunks:
        return
    if len(chunks) == 1:
        yield _piece_to_device(chunks, device)
        return

    sample = np.concatenate(samples, axis=0)
    sample = sample[np.lexsort(sample.T[::-1])]
    nranges = max(2 * (n // m + 1), 2)
    step = max(len(sample) // nranges, 1)
    splitters = sample[step::step]

    his = []
    for hi_key in list(splitters) + [None]:
        his.append([
            len(mat) if hi_key is None else _searchsorted_rows(mat, hi_key, "right")
            for mat, _ in chunks
        ])
    los = [[0] * len(chunks)] + his[:-1]
    stack = list(reversed([list(zip(lo, hi)) for lo, hi in zip(los, his)]))
    while stack:
        slices = stack.pop()
        total = sum(hi - lo for lo, hi in slices)
        if total == 0:
            continue
        live = [(i, lo, hi) for i, (lo, hi) in enumerate(slices) if hi > lo]
        if total <= m:
            yield _sorted_range(
                [(chunks[i][0][lo:hi], chunks[i][1][lo:hi]) for i, lo, hi in live], device)
            continue
        # oversized range (the splitter sample missed): all-equal keys cannot
        # be split, but then chunk-concatenation order is global index order
        # (chunks partition the index space in ascending blocks), so bounded
        # sub-slices stream out.  Mixed ranges re-split at their median key.
        lo_key = min(tuple(chunks[i][0][lo]) for i, lo, _ in live)
        hi_key = max(tuple(chunks[i][0][hi - 1]) for i, _, hi in live)
        if lo_key == hi_key:
            for i, lo, hi in live:
                for s in range(lo, hi, m):
                    e = min(s + m, hi)
                    yield _piece_to_device([(chunks[i][0][s:e], chunks[i][1][s:e])], device)
            continue
        samp = []
        for i, lo, hi in live:
            stride = max((hi - lo) // 64, 1)
            samp.append(chunks[i][0][lo:hi:stride])
        sample_r = np.concatenate(samp, axis=0)
        sample_r = sample_r[np.lexsort(sample_r.T[::-1])]
        med = sample_r[len(sample_r) // 2]
        side = "right" if tuple(med) == lo_key else "left"
        left, right = [], []
        for i, (lo, hi) in enumerate(slices):
            mid = lo + _searchsorted_rows(chunks[i][0][lo:hi], med, side)
            left.append((lo, mid))
            right.append((mid, hi))
        stack.append(right)
        stack.append(left)


def _gather_rows_chunked(batch: RecordBatch, idx: torch.Tensor, mem_rows: int) -> list[RecordBatch]:
    """Rows of `batch` at the device indices `idx` (int32), gathered at most
    mem_rows per device call (K4), as device batches in order."""
    m = max(int(mem_rows), 1)
    return [batch.take_fill(idx[lo: lo + m]) for lo in range(0, idx.shape[0], m)]


def _assemble_capacity_batch(batch: RecordBatch, parts: list[RecordBatch],
                             capacity: int) -> RecordBatch:
    """Device batch of `capacity` rows: the gathered rows first, zero rows
    with valid False after (the zero-fill convention of the in-memory ops)."""
    pad = capacity - sum(p.nrows for p in parts)
    dev = batch.recid.device
    if pad or not parts:
        parts = parts + [RecordBatch(
            recid=torch.zeros(pad, dtype=torch.int32, device=dev),
            num=torch.zeros(pad, dtype=torch.int32, device=dev),
            strw=torch.zeros((pad, batch.str_words), dtype=torch.int32, device=dev),
            valid=torch.zeros(pad, dtype=torch.bool, device=dev),
        )]
    return parts[0] if len(parts) == 1 else RecordBatch.concat(parts)


def _cat_indices(pieces: list[torch.Tensor], device) -> torch.Tensor:
    if not pieces:
        return torch.zeros(0, dtype=torch.int32, device=device)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def sort_batch_chunked(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
) -> tuple[RecordBatch, torch.Tensor]:
    """``sort_batch`` for batches beyond the budget (chunked passes).

    The contract of ``sort.sort_batch_impl``: (sorted_batch, perm), live rows
    first in exact key order, padding rows (past `count`) sunk to the tail in
    index order, all rows preserved.
    """
    use_sort_placement(cfg)
    order = [g for _, g in _global_key_order(batch, field, cfg, cfg.mem_rows, count)]
    perm = _cat_indices(order, batch.recid.device)
    parts = _gather_rows_chunked(batch, perm, cfg.mem_rows)
    return _assemble_capacity_batch(batch, parts, batch.nrows), perm


def distinct_chunked(
    batch: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
    active=None,
) -> tuple[RecordBatch, torch.Tensor]:
    """``distinct`` for batches beyond the budget (chunked passes).

    The contract of ``distinct.distinct_impl``: a capacity-N batch holding
    the first live row of each key group in key order, rows past nunique
    zero; `active` composes with `count` as in ``distinct_view``.
    """
    use_sort_placement(cfg)
    surv: list[torch.Tensor] = []
    prev_key = None
    for cols, gidx in _global_key_order(batch, field, cfg, cfg.mem_rows, count, active):
        # a piece is in (inactive, key, index) order: its active rows come first
        n_act = int((cols[0] == 0).sum())
        if n_act == 0:
            continue  # inactives sort last globally
        kw = [c[:n_act] for c in cols[1:]]
        keep = ~adj_equal(kw, None)  # the first row of each key group (K6)
        first_key = torch.stack([c[0] for c in kw])
        if prev_key is not None and torch.equal(first_key, prev_key):
            keep[0] = False  # the group began in the piece before
        prev_key = torch.stack([c[n_act - 1] for c in kw])
        n_keep, (front,) = compact_words(keep, (gidx[:n_act],))
        surv.append(front[: int(n_keep)])
    sp = _cat_indices(surv, batch.recid.device)
    parts = _gather_rows_chunked(batch, sp, cfg.mem_rows)
    out = _assemble_capacity_batch(batch, parts, batch.nrows)
    return out, torch.tensor(sp.shape[0], dtype=torch.int32, device=batch.recid.device)


def compact_rows_chunked(
    batch: RecordBatch,
    keep: torch.Tensor,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor]:
    """Kept rows to the front (original order), zero rows after: the form of
    ``movement.compact_rows`` for batches beyond the budget.  The kept rows
    are listed on the device, a budget-sized chunk of the mask at a time (K3),
    for the gather chunks (K4)."""
    use_sort_placement(cfg)
    dev = batch.recid.device
    m = max(int(cfg.mem_rows), 1)
    kept = []
    for lo in range(0, batch.nrows, m):
        rows = torch.arange(lo, min(lo + m, batch.nrows), dtype=torch.int32, device=dev)
        n_keep, (front,) = compact_words(keep[lo: lo + m], (rows,))
        kept.append(front[: int(n_keep)])
    idx = _cat_indices(kept, dev)
    parts = _gather_rows_chunked(batch, idx, cfg.mem_rows)
    out = _assemble_capacity_batch(batch, parts, batch.nrows)
    return out, torch.tensor(idx.shape[0], dtype=torch.int32, device=dev)
