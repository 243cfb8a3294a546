"""K11: tile copy by bulk asynchronous copies (``csrc/tile_copy.cu``) and its
plain torch version.

Replaces the Pallas probe ``make_kernel(G, n)`` (``tools/bench_pallas_dma.py:43,73``
of the repository), which measures what it costs to issue a copy: a tile of
T record rows is loaded once and stored back as T/G chunks of G rows at
runtime offsets.

The kernel's plan (``copy_plan``): the rows are cut into units of
``stage_rows(T, W)`` rows, which lie in one tile; a persistent grid of
``blocks_per_sm`` blocks an SM (``copy_grid``), all resident at once, takes
the units one at a time from a counter the blocks share; a block keeps a
ring of ``ring`` unit buffers in shared memory, and its one thread reloads
the buffer of its unit k - 1 as soon as the stores of unit k are issued and
those of unit k - 1 have read it.  The counter is ``COUNTER_BYTES`` that
the wrapper allocates for each call and the C entry zeroes on the call's
stream before the launch, so calls on two streams, or one after a launch
that failed midway, share nothing.  ``tools/copy_sweep.py`` times the unit,
ring and blocks an SM on the card, by setting the constants below around
``tile_copy`` calls; ``PERF.md`` has the readings that chose them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _lib

UNIT_BYTES = 8 * 1024  # a unit's bytes at most (64 rows of 32 words)
RING = 6  # unit buffers a block
BLOCKS_PER_SM = 32  # at most: the plan keeps every block of the grid resident
MAX_RING = 16  # MAX_RING in csrc/tile_copy.cu
RING_BYTES = 232448 - 1024  # a block's dynamic shared memory, its barriers aside
SM_SHARED_BYTES = 233472  # an SM's shared memory
BLOCK_SHARED_BYTES = 1024 + 8 * 3 * MAX_RING  # reserved a block, and the kernel's static arrays
MAX_BLOCKS_PER_SM = 32
COUNTER_BYTES = 16  # the launch's unit counter (COUNTER_BYTES in csrc/tile_copy.cu)
H100_SMS = 132


class CopyPlan(NamedTuple):
    unit_rows: int
    ring: int
    blocks_per_sm: int


def stage_rows(T: int, W: int) -> int:
    """S, the rows of a unit: the largest multiple of 32 rows that divides
    the tile and fits ``UNIT_BYTES`` (64 rows for the probe's W = 32), at
    least 32 rows."""
    fits = [s for s in range(32, T + 1, 32) if T % s == 0 and s * W * 4 <= UNIT_BYTES]
    if fits:
        return fits[-1]
    if T % 32:
        raise ValueError(f"tile_copy: a tile of {T} rows is not a multiple of 32 rows")
    return 32


def resident_blocks(ring_bytes: int) -> int:
    """The blocks an SM holds at once when each has a ring of `ring_bytes`."""
    return min(SM_SHARED_BYTES // (ring_bytes + BLOCK_SHARED_BYTES), MAX_BLOCKS_PER_SM)


def copy_plan(T: int, W: int) -> CopyPlan:
    """K11's plan for tiles of T rows of W words, from ``UNIT_BYTES``,
    ``RING`` and ``BLOCKS_PER_SM``: the ring shrinks to fit shared memory,
    the blocks an SM to those that are resident together.  Raises
    ValueError on what the kernel refuses: a ring of fewer than 2 or more
    than ``MAX_RING`` buffers or past ``RING_BYTES``, fewer than one block
    an SM."""
    s = stage_rows(T, W)
    unit_bytes = s * W * 4
    r = min(RING, RING_BYTES // unit_bytes)
    if not 2 <= r <= MAX_RING:
        raise ValueError(f"tile_copy: a ring of {r} units of {unit_bytes} B; the kernel takes "
                         f"2-{MAX_RING} buffers within {RING_BYTES} B of shared memory")
    bps = min(BLOCKS_PER_SM, resident_blocks(r * unit_bytes))
    if bps < 1:
        raise ValueError(f"tile_copy: {BLOCKS_PER_SM} blocks an SM")
    return CopyPlan(s, r, bps)


def copy_grid(n: int, plan: CopyPlan, sms: int = H100_SMS) -> int:
    """The blocks of one launch over n rows: blocks_per_sm a streaming
    multiprocessor, at most one a unit."""
    return max(min(plan.blocks_per_sm * sms, n // plan.unit_rows), 1)


def chunk_parts(lo: int, S: int, G: int) -> list[tuple[int, int]]:
    """[a, e) tile rows of each store of the unit whose first tile row is lo:
    each chunk of G rows clipped to the unit."""
    return [(max(j * G, lo), min((j + 1) * G, lo + S))
            for j in range(lo // G, (lo + S - 1) // G + 1)]


def bulk_copies(n: int, G: int, T: int = 2048, W: int = 32) -> int:
    """The bulk copies one call issues under the plan: a load a unit and a
    store a chunk part of a unit (a chunk that spans units is one store
    each), whichever block takes the unit."""
    S = stage_rows(T, W)
    per_tile = sum(1 + len(chunk_parts(lo, S, G)) for lo in range(0, T, S))
    return (n // T) * per_tile


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
    n = x.numel() // W
    if n == 0:
        return out
    plan = copy_plan(T, W)
    blocks = copy_grid(n, plan, torch.cuda.get_device_properties(dev).multi_processor_count)
    counter = torch.empty(COUNTER_BYTES // 8, dtype=torch.int64, device=dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_tile_copy(x.data_ptr(), st.data_ptr(), out.data_ptr(), n // T, T, W, G,
                                plan.unit_rows, plan.ring, blocks, counter.data_ptr(),
                                _lib.stream_of(x))
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
