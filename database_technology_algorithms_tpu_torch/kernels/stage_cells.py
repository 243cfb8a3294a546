"""K9: rows staged into padded cells (``csrc/stage_cells.cu``), the counting
primitive ``value_boundaries``, and their plain torch versions.

Replaces the JAX package's ``stage_to_cells`` (``ops/movement.py:354``) and
``value_boundaries`` (``ops/movement.py:319``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import as_u32
from . import _lib
from .words_sort import words_sort

ROW_MAPS = ("slots", "si", "none")


def value_boundaries(d: torch.Tensor, nprobes: int) -> torch.Tensor:
    """``out[p]`` = the number of elements of `d` (int32 holding u32) below
    p, for p in [0, nprobes); `d` need not be sorted.  Per-part counts are
    the differences of ``value_boundaries(d, nparts + 1)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    histogram and scan.
    """
    if d.device.type == "cpu":
        return value_boundaries_plain(d, nprobes)
    _lib.check_cuda("value_boundaries d", d, torch.int32)
    if d.dim() != 1 or nprobes < 0:
        raise ValueError("value_boundaries: d must be [N] and nprobes >= 0")
    out = torch.empty(nprobes, dtype=torch.int32, device=d.device)
    if nprobes == 0:
        return out
    lib = _lib.library()
    scratch = torch.empty(
        lib.dbt_value_boundaries_scratch_words(nprobes), dtype=torch.int32, device=d.device
    )
    with torch.cuda.device(d.device):
        err = lib.dbt_value_boundaries(
            d.data_ptr(), d.shape[0], nprobes, out.data_ptr(), scratch.data_ptr(),
            _lib.stream_of(d),
        )
    _lib.raise_on_error(err, "value_boundaries")
    _lib.LAUNCHES["stage_cells"] += 1
    return out


def value_boundaries_plain(d: torch.Tensor, nprobes: int) -> torch.Tensor:
    """The same counts from a bincount of the clamped values."""
    if nprobes == 0:
        return torch.zeros(0, dtype=torch.int32, device=d.device)
    hist = torch.bincount(as_u32(d).clamp(max=nprobes), minlength=nprobes + 1)[:nprobes]
    return (torch.cumsum(hist, 0) - hist).to(torch.int32)


def stage_to_cells(
    dest: torch.Tensor,
    active: torch.Tensor | None,
    nparts: int,
    cap: int,
    payloads: Sequence[torch.Tensor],
    row_map: str = "slots",
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """Stage rows into padded [nparts, cap] cells by destination id.

    Every active row with ``dest[i] < nparts`` (`dest` int32 holding u32)
    lands in cell ``dest[i]`` at its rank among that cell's rows, in row
    order, live rows packed to the front.  Returns ``(cells, counts,
    row_map_out, overflow)``: one int32[nparts * cap] array per payload word
    (int32[N] columns, possibly strided), dead slots zero; the per-cell live
    counts clamped to cap (int32[nparts]); and the number of active rows
    beyond their cell's capacity, which are not staged (0-d int32).
    `row_map` selects the third output:

      "slots"  the flat slot of every row (``nparts * cap`` for rows that
               were inactive, out of range or beyond capacity);
      "si"     the staging permutation: the row indices ordered by
               (destination, row), inactive rows sorting as destination
               `nparts`; it is slot order while nothing overflowed;
      "none"   None.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if row_map not in ROW_MAPS:
        raise ValueError(f"stage_to_cells: unknown row_map {row_map!r}")
    if nparts < 1 or cap < 1:
        raise ValueError("stage_to_cells: nparts and cap must be positive")
    payloads = list(payloads)
    if dest.device.type == "cpu":
        return stage_to_cells_plain(dest, active, nparts, cap, payloads, row_map)
    dev = dest.device
    n = dest.shape[0]
    _lib.check_cuda("stage_to_cells dest", dest, torch.int32)
    if dest.dim() != 1:
        raise ValueError("stage_to_cells: dest must be [N]")
    if active is not None:
        _lib.check_cuda("stage_to_cells active", active, torch.bool, dev)
        if active.shape != (n,):
            raise ValueError("stage_to_cells: active must be [N] like dest")
    _lib.check_columns("stage_to_cells payload", payloads, n, dev)
    m = nparts * cap
    cells = [torch.empty(m, dtype=torch.int32, device=dev) for _ in payloads]
    counts = torch.empty(nparts, dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    si = torch.empty(n, dtype=torch.int32, device=dev)
    slots = torch.empty(n, dtype=torch.int32, device=dev) if row_map == "slots" else None
    lib = _lib.library()
    scratch = torch.empty(
        lib.dbt_stage_cells_scratch_words(n, nparts), dtype=torch.int32, device=dev
    )
    with torch.cuda.device(dev):
        err = lib.dbt_stage_cells(
            dest.data_ptr(), None if active is None else active.data_ptr(), n, nparts, cap,
            _lib.ptr_array(payloads), _lib.stride_array(payloads), _lib.ptr_array(cells),
            len(payloads), counts.data_ptr(), stats.data_ptr(), si.data_ptr(),
            None if slots is None else slots.data_ptr(), scratch.data_ptr(),
            _lib.stream_of(dest),
        )
    _lib.raise_on_error(err, "stage_to_cells")
    _lib.LAUNCHES["stage_cells"] += 1
    overflow = stats[0]
    if row_map == "slots":
        return cells, counts, slots, overflow
    if row_map == "none":
        return cells, counts, None, overflow
    beyond, nsink = stats[1:].tolist()
    if beyond:
        # active rows with a destination above nparts sort after the inactive
        # rows, by (destination, row); the sink bucket holds them all in row
        # order, so it is ordered once more by its rows' own word (K5)
        sink = si[n - nsink:]
        rows = sink.long()
        word = dest[rows] if active is None else torch.where(active[rows], dest[rows], nparts)
        order, _, _ = words_sort([word])
        sink.copy_(sink[order.long()])
    return cells, counts, si, overflow


def stage_to_cells_plain(
    dest: torch.Tensor,
    active: torch.Tensor | None,
    nparts: int,
    cap: int,
    payloads: Sequence[torch.Tensor],
    row_map: str = "slots",
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """The same staging from one stable torch.sort of the destinations."""
    n = dest.shape[0]
    dev = dest.device
    m = nparts * cap
    d = as_u32(dest)
    if active is not None:
        d = torch.where(active, d, nparts)
    sd, si = torch.sort(d, stable=True)
    bucket = sd.clamp(max=nparts)
    hist = torch.bincount(bucket, minlength=nparts + 1)
    start = torch.cumsum(hist, 0) - hist
    rank = torch.arange(n, device=dev) - start[bucket]
    in_range = sd < nparts
    ok = in_range & (rank < cap)
    slot = torch.where(ok, sd * cap + rank, m)
    cells = []
    for w in payloads:
        cell = torch.zeros(m, dtype=torch.int32, device=dev)
        cell[slot[ok]] = w[si[ok]]
        cells.append(cell)
    counts = hist[:nparts].clamp(max=cap).to(torch.int32)
    overflow = (in_range & (rank >= cap)).sum(dtype=torch.int32)
    if row_map == "slots":
        slot_of_row = torch.empty(n, dtype=torch.int32, device=dev)
        slot_of_row[si] = slot.to(torch.int32)
        return cells, counts, slot_of_row, overflow
    return cells, counts, si.to(torch.int32) if row_map == "si" else None, overflow
