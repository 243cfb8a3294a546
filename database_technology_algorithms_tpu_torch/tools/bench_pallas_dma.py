"""Tile-copy probe: what it costs to issue a bulk copy (K11).

The counterpart of the repository's ``tools/bench_pallas_dma.py``: a tile of
T record rows (W = 32 words, 128 B) is loaded into shared memory once and
stored back as T/G chunks of G rows at runtime offsets; the slope of the
time against 1/G gives the cost of one copy, and G = T the bandwidth of the
pattern.  Identity offsets keep the copy checkable; they still arrive as
runtime data.  Per G it prints the time, the rate (2·n·W·4 B over the time),
the bulk copies issued (a load a unit of 64 rows, a store a chunk part of a
unit: ``kernels/tile_copy.bulk_copies``) and the time per copy.

    python -m database_technology_algorithms_tpu_torch.tools.bench_pallas_dma [--cpu]

``--cpu`` runs the plain version at n = 2^14 rows, for correctness only.
"""

from __future__ import annotations

import sys

import torch

from ..kernels.tile_copy import bulk_copies, tile_copy
from ..utils.checks import resolve_device
from . import cuda_ms, device_name

N = 1 << 20  # record rows
W = 32  # u32 words per record row (128 B)
T = 2048  # record rows per tile
GS = (32, 64, 128, 512, T)


def make_kernel(G: int, n: int):
    """The copy of n record rows with G-row chunks: ``fn(x, starts)`` with x
    int32 [n*W/128, 128] and starts int32 [n/T] (record rows; on the host,
    as the TPU's scalar prefetch takes them, or on the card)."""

    def fn(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        if x.numel() != n * W:
            raise ValueError(f"make_kernel({G}, {n}): x holds {x.numel() // W} rows")
        return tile_copy(x, starts, G, T, W)

    return fn


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    n = 1 << 14 if cpu else N
    dev = resolve_device("cpu" if cpu else None)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 1 << 30, (n * W // 128, 128), generator=gen, dtype=torch.int32).to(dev)
    starts = torch.arange(n // T, dtype=torch.int32) * T
    print(f"device: {device_name(dev)}  N={n} T={T} W={W}", flush=True)
    for G in GS:
        fn = make_kernel(G, n)
        if cpu:
            print(f"G={G:5d} plain ok={torch.equal(fn(x, starts), x)}", flush=True)
            continue
        per = cuda_ms(lambda: fn(x, starts)) / 1e3
        copies = bulk_copies(n, G, T, W)
        print(f"G={G:5d}  {per * 1e3:8.4f} ms  {2 * n * W * 4 / per / 1e9:7.1f} GB/s  "
              f"{copies} bulk copies -> {per / copies * 1e9:7.1f} ns/copy", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
