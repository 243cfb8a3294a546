"""K11: tile copy by bulk asynchronous copies (``csrc/tile_copy.cu``) and its
plain torch version.

Replaces the Pallas probe ``make_kernel(G, n)`` (``tools/bench_pallas_dma.py:43,73``
of the repository), which measures what it costs to issue a copy: a tile of
T record rows is loaded once and stored back as T/G chunks of G rows at
runtime offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib

SMEM_STAGE_BYTES = 128 * 1024  # a stage of a tile in one block's shared memory


def stage_rows(T: int, W: int) -> int:
    """Rows of a tile staged at a time: T halved until the stage fits
    ``SMEM_STAGE_BYTES`` (1024 rows, two stages, for the probe's T = 2048,
    W = 32)."""
    s = T
    while s * W * 4 > SMEM_STAGE_BYTES:
        if s % 2:
            raise ValueError(f"tile_copy: a tile of {T} rows of {W} words cannot be staged")
        s //= 2
    if s % 32:
        raise ValueError(f"tile_copy: a stage of {s} rows is not a multiple of 32 rows")
    return s


def bulk_copies(n: int, G: int, T: int = 2048, W: int = 32) -> int:
    """The bulk copies one call issues: a load per stage and a store per
    chunk part of a stage (a chunk that spans stages is one store each)."""
    s = stage_rows(T, W)
    per_stage = max(s // G, 1)
    return (n // T) * (T // s) * (1 + per_stage)


def _check(x: torch.Tensor, starts: torch.Tensor, G: int, T: int, W: int) -> None:
    """Raise ValueError on the arguments the kernel does not take (the
    starts are read on the host)."""
    if x.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError(f"tile_copy: expected int32 x and starts, got {x.dtype}, {starts.dtype}")
    if W < 1 or x.numel() % W:
        raise ValueError(f"tile_copy: {x.numel()} words are not rows of {W} words")
    n = x.numel() // W
    if T < 1 or n % T:
        raise ValueError(f"tile_copy: {n} rows are not a whole number of tiles of {T}")
    if G < 1 or T % G:
        raise ValueError(f"tile_copy: G={G} does not divide the tile of {T} rows")
    if G % 32:
        raise ValueError(f"tile_copy: G={G} is not a multiple of 32 rows")
    if starts.shape != (n // T,):
        raise ValueError(f"tile_copy: starts must be [{n // T}], got {tuple(starts.shape)}")
    s = starts.cpu().numpy().astype(np.int64)
    if (s % 32).any():
        raise ValueError("tile_copy: every start must be a multiple of 32 rows")
    if (s < 0).any() or (s + T > n).any():
        raise ValueError(f"tile_copy: a tile starting at a start must lie inside [0, {n})")
    ordered = np.sort(s)
    if (ordered[1:] < ordered[:-1] + T).any():
        raise ValueError("tile_copy: two tiles overlap")


def tile_copy(x: torch.Tensor, starts: torch.Tensor, G: int, T: int = 2048,
              W: int = 32) -> torch.Tensor:
    """View `x` (int32 words) as [n, W] record rows; for each tile t of T
    rows and chunk j < T/G, ``out[starts[t] + j*G : +G] = x[t*T + j*G : +G]``.
    Returns out in the shape of `x`.

    Raises ValueError unless n % T == 0, G divides T, G % 32 == 0 and every
    start is a multiple of 32 rows with ``starts[t] + T <= n``; tiles may not
    overlap, so the tiles cover every row of out.  `starts` (int32
    [n/T]) is checked on the host and may lie there even when `x` is on the
    card, as the TPU's scalar prefetch takes it.

    A CPU `x` takes the plain version; a CUDA `x` launches the kernel.
    """
    _check(x, starts, G, T, W)
    if x.device.type == "cpu":
        return tile_copy_plain(x, starts, G, T, W)
    dev = x.device
    _lib.check_cuda("tile_copy x", x, torch.int32)
    if x.data_ptr() % 16:
        raise ValueError("tile_copy: bulk copies need x 16-byte aligned")
    st = starts.to(dev, torch.int32).contiguous()
    out = torch.empty_like(x)
    ntiles = x.numel() // W // T
    if ntiles == 0:
        return out
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_tile_copy(x.data_ptr(), st.data_ptr(), out.data_ptr(), ntiles, T, W, G,
                                stage_rows(T, W), _lib.stream_of(x))
    _lib.raise_on_error(err, "tile_copy")
    _lib.LAUNCHES["tile_copy"] += 1
    return out


def tile_copy_plain(x: torch.Tensor, starts: torch.Tensor, G: int, T: int = 2048,
                    W: int = 32) -> torch.Tensor:
    """The same copy as slice assignments on [n, W]: the chunks of a tile
    land back to back at its start, so one assignment a tile."""
    rows = x.reshape(-1, W)
    out = torch.zeros_like(rows)
    for t, s in enumerate(starts.tolist()):
        out[s: s + T] = rows[t * T: (t + 1) * T]
    return out.reshape(x.shape)
