"""K12: tile-relative row gather or scatter (``csrc/row_move.cu``, on the
row-move engine of ``csrc/rowmove.cuh``) and its plain torch version.

Replaces the Pallas probe ``make_rowmove(load)`` (``tools/bench_permute_prims.py:155,176``
of the repository, P5 and P4).  With one tile spanning all rows it is the
word-placement gather of the placement route (``ops/movement.py``).
"""

from __future__ import annotations

import torch

from . import _lib, rowmove_plan


def _check(x: torch.Tensor, slot: torch.Tensor, tile: int, load: bool, count) -> None:
    if x.dim() != 2:
        raise ValueError(f"row_move: x must be [N, W], got shape {tuple(x.shape)}")
    if slot.shape != (x.shape[0],):
        raise ValueError(f"row_move: slot must be [{x.shape[0]}], got {tuple(slot.shape)}")
    if x.dtype != torch.int32 or slot.dtype != torch.int32:
        raise TypeError(f"row_move: expected int32 x and slot, got {x.dtype}, {slot.dtype}")
    if tile < 1:
        raise ValueError(f"row_move: tile must be >= 1, got {tile}")
    if count is not None and not load:
        raise ValueError("row_move: a live count applies to the load form only")


def row_move(x: torch.Tensor, slot: torch.Tensor, tile: int, load: bool,
             count=None) -> torch.Tensor:
    """Move the rows of `x` (int32 [N, W] of u32 words) within tiles of
    `tile` rows; tile t covers rows [t*tile, min((t+1)*tile, N)) and `slot`
    (int32 [N]) holds tile-relative rows.

    ``load=True``: ``out[t*tile + j] = x[t*tile + slot[t*tile + j]]``, a zero
    row where the slot lies outside the tile or, with `count` (an int or a
    0-d integer tensor on the device), where the position is at or past it.
    ``load=False``: ``out[t*tile + slot[t*tile + j]] = x[t*tile + j]`` for
    slots inside the tile, into a zero output; the slots of a tile must be
    distinct (the probe's are a permutation of it), or which row lands is
    unspecified.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    _check(x, slot, tile, load, count)
    if x.device.type == "cpu":
        return row_move_plain(x, slot, tile, load, count)
    dev = x.device
    _lib.check_cuda("row_move x", x, torch.int32)
    _lib.check_cuda("row_move slot", slot, torch.int32, dev)
    n, w = x.shape
    out = torch.empty_like(x) if load else torch.zeros_like(x)
    if n == 0 or w == 0:
        return out
    vec = rowmove_plan.access_words(w, x.data_ptr(), out.data_ptr())
    rowmove_plan.check_shape("row_move", n, n, w // vec)
    cnt, cnt_host = rowmove_plan.count_arg(count, n, dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_row_move(x.data_ptr(), slot.data_ptr(), out.data_ptr(), n, w, tile,
                               int(load), None if cnt is None else cnt.data_ptr(), cnt_host,
                               vec, rowmove_plan.block_rows(w // vec, 2 * n * w * 4),
                               _lib.stream_of(x))
    _lib.raise_on_error(err, "row_move")
    _lib.LAUNCHES["row_move"] += 1
    return out


def row_move_plain(x: torch.Tensor, slot: torch.Tensor, tile: int, load: bool,
                   count=None) -> torch.Tensor:
    """The same move as torch indexing (a gather or an index assignment)."""
    _check(x, slot, tile, load, count)
    n = x.shape[0]
    rows = torch.arange(n, device=x.device)
    base = rows - rows % tile
    other = base + slot.long()
    ok = (slot >= 0) & (other < torch.clamp(base + tile, max=n))
    if count is not None:
        ok &= rowmove_plan.live_positions(n, count, x.device)
    if load:
        return torch.where(ok[:, None], x[torch.where(ok, other, 0)], 0)
    out = torch.zeros_like(x)
    out[other[ok]] = x[ok]
    return out
