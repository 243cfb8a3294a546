"""K9: rows staged into padded cells (``csrc/stage_cells.cu``), the counting
primitive ``value_boundaries``, and their plain torch versions.

Replaces the JAX package's ``stage_to_cells`` (``ops/movement.py:354``) and
``value_boundaries`` (``ops/movement.py:319``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import as_u32
from . import _lib, cells_plan, rowmove_plan
from .words_sort import words_sort

ROW_MAPS = ("slots", "si", "none")


def value_boundaries(d: torch.Tensor, nprobes: int) -> torch.Tensor:
    """``out[p]`` = the number of elements of `d` (int32 holding u32) below
    p, for p in [0, nprobes); `d` need not be sorted.  Per-part counts are
    the differences of ``value_boundaries(d, nparts + 1)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    count and scan (``cells_plan``), for at most 58111 probes.
    """
    if d.device.type == "cpu":
        return value_boundaries_plain(d, nprobes)
    _lib.check_cuda("value_boundaries d", d, torch.int32)
    if d.dim() != 1 or nprobes < 0:
        raise ValueError("value_boundaries: d must be [N] and nprobes >= 0")
    out = torch.empty(nprobes, dtype=torch.int32, device=d.device)
    if nprobes == 0:
        return out
    n = d.shape[0]
    cells_plan.check_boundaries("value_boundaries", n, nprobes, cells_plan.SPAN)
    words = cells_plan.boundary_scratch_words(n, nprobes, cells_plan.SPAN)
    scratch = torch.empty(words, dtype=torch.int32, device=d.device)
    lib = _lib.library()
    with torch.cuda.device(d.device):
        err = lib.dbt_value_boundaries(
            d.data_ptr(), n, nprobes, out.data_ptr(), scratch.data_ptr(), words,
            cells_plan.SPAN, _lib.stream_of(d),
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
    count=None,
    in_range: bool = False,
    fill: int = 0,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """Stage rows into padded [nparts, cap] cells by destination id.

    Every active row with ``dest[i] < nparts`` (`dest` int32 holding u32)
    lands in cell ``dest[i]`` at its rank among that cell's rows, in row
    order, live rows packed to the front.  A row is active where `active`
    (bool[N], None: every row) holds and, given `count` (an int or a 0-d
    integer tensor on the device), where ``i < count``: the JAX package's
    ``active`` of ``arange(N) < count``, whose rows past it the kernel does
    not read.  Returns ``(cells, counts, row_map_out, overflow)``: one
    int32[nparts * cap] array per payload word (int32[N] columns, possibly
    strided), dead slots holding `fill` (a u32 value, or its int32 bits;
    0 unless given); the per-cell live counts clamped to cap
    (int32[nparts]); and the number of active rows beyond their cell's
    capacity, which are not staged (0-d int32).  `row_map` selects the third
    output:

      "slots"  the flat slot of every row (``nparts * cap`` for rows that
               were inactive, out of range or beyond capacity);
      "si"     the staging permutation: the row indices ordered by
               (destination, row), inactive rows sorting as destination
               `nparts`; it is slot order while nothing overflowed;
      "none"   None.

    Active rows with a destination above `nparts` sort after the inactive
    ones in "si"; the card puts them in row order with the inactive rows and
    the wrapper reads their number on the host to order them (K5).
    `in_range` is the caller's promise that no active destination exceeds
    `nparts` (the tiled join masks its hashes): that read is then skipped,
    and nothing of the call waits for the host.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if row_map not in ROW_MAPS:
        raise ValueError(f"stage_to_cells: unknown row_map {row_map!r}")
    if nparts < 1 or cap < 1:
        raise ValueError("stage_to_cells: nparts and cap must be positive")
    payloads = list(payloads)
    fill = _fill_bits(fill)
    if dest.device.type == "cpu":
        return stage_to_cells_plain(dest, active, nparts, cap, payloads, row_map, count, fill)
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
    warps = cells_plan.check_stage("stage_to_cells", n, nparts, cap, cells_plan.SPAN)
    cnt, cnt_host = rowmove_plan.count_arg(count, n, dev)
    if count is not None and cnt is None:  # a host count: the same on the card
        cnt = torch.full((), cnt_host, dtype=torch.int32, device=dev)
    m = nparts * cap
    cells = [torch.empty(m, dtype=torch.int32, device=dev) for _ in payloads]
    counts = torch.empty(nparts, dtype=torch.int32, device=dev)
    stats = torch.empty(3, dtype=torch.int32, device=dev)
    si = torch.empty(n, dtype=torch.int32, device=dev) if row_map == "si" else None
    slots = torch.empty(n, dtype=torch.int32, device=dev) if row_map == "slots" else None
    words = cells_plan.stage_scratch_words(n, nparts, cells_plan.SPAN)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_stage_cells(
            dest.data_ptr(), None if active is None else active.data_ptr(),
            None if cnt is None else cnt.data_ptr(), n, nparts, cap,
            _lib.ptr_array(payloads), _lib.stride_array(payloads), _lib.ptr_array(cells),
            len(payloads), fill & 0xFFFFFFFF, counts.data_ptr(), stats.data_ptr(),
            None if si is None else si.data_ptr(), None if slots is None else slots.data_ptr(),
            scratch.data_ptr(), words, cells_plan.SPAN, warps, _lib.stream_of(dest),
        )
    _lib.raise_on_error(err, "stage_to_cells")
    _lib.LAUNCHES["stage_cells"] += 1
    overflow = stats[0]
    if row_map == "slots":
        return cells, counts, slots, overflow
    if row_map == "none" or in_range:
        return cells, counts, si, overflow
    beyond, nsink = stats[1:].tolist()
    if beyond:
        # active rows with a destination above nparts sort after the inactive
        # rows, by (destination, row); the sink bucket holds them all in row
        # order, so it is ordered once more by its rows' own word (K5)
        sink = si[n - nsink:]
        rows = sink.long()
        word = dest[rows]
        if active is not None:
            word = torch.where(active[rows], word, nparts)
        if cnt is not None:
            word = torch.where(rows < cnt, word, nparts)
        order, _, _ = words_sort([word])
        sink.copy_(sink[order.long()])
    return cells, counts, si, overflow


def _fill_bits(fill: int) -> int:
    """A u32 fill value (or its int32 bits) as the int32 the cells hold."""
    fill = int(fill)
    if not -(1 << 31) <= fill < 1 << 32:
        raise ValueError(f"stage_to_cells: fill {fill} is not a u32 value")
    return fill - (1 << 32) if fill >= 1 << 31 else fill


def stage_to_cells_plain(
    dest: torch.Tensor,
    active: torch.Tensor | None,
    nparts: int,
    cap: int,
    payloads: Sequence[torch.Tensor],
    row_map: str = "slots",
    count=None,
    fill: int = 0,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """The same staging from one stable torch.sort of the destinations."""
    n = dest.shape[0]
    dev = dest.device
    m = nparts * cap
    d = as_u32(dest)
    if count is not None:
        live = rowmove_plan.live_positions(n, count, dev)
        active = live if active is None else active & live
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
        cell = torch.full((m,), _fill_bits(fill), dtype=torch.int32, device=dev)
        cell[slot[ok]] = w[si[ok]]
        cells.append(cell)
    counts = hist[:nparts].clamp(max=cap).to(torch.int32)
    overflow = (in_range & (rank >= cap)).sum(dtype=torch.int32)
    if row_map == "slots":
        slot_of_row = torch.empty(n, dtype=torch.int32, device=dev)
        slot_of_row[si] = slot.to(torch.int32)
        return cells, counts, slot_of_row, overflow
    return cells, counts, si.to(torch.int32) if row_map == "si" else None, overflow
