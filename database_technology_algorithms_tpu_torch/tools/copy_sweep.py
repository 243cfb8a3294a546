"""K11's plan (``kernels/tile_copy.py``) swept on the card.

Times the tile copy at the probe's shape (n = 2^20 rows of W = 32 words,
tiles of T = 2048, identity starts) under every plan of unit rows S (64-512),
ring R (2, 3, 4, 6, 8) and blocks an SM (1, 2, 4, 8, up to those resident
together) whose ring fits a block's shared memory, at G = 32 and G = 2048.
Each plan is set through ``tile_copy``'s constants around ordinary
``tile_copy`` calls; the plan's numbers are arguments of the kernel, so one
build serves them all.  Then the ten fastest at G = 32 again, each three
times in turns with ``copy_`` of the same words (the median), and the
default plan at every G of the probe.  A time is the median device time of
the kernel over ``scan_sweep.REPS`` calls (torch.profiler), in ms.
``tile_copy.py``'s UNIT_BYTES, RING and BLOCKS_PER_SM are the ones these
readings chose.

    python -m database_technology_algorithms_tpu_torch.tools.copy_sweep
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess

import torch

from ..kernels import tile_copy as k11
from . import bench_pallas_dma as dma
from . import device_name
from .scan_sweep import kernel_ms

UNIT_ROWS = (64, 128, 256, 512)
RINGS = (2, 3, 4, 6, 8)
BLOCKS_PER_SM = (1, 2, 4, 8, k11.MAX_BLOCKS_PER_SM)


@contextlib.contextmanager
def plan(**values):
    """tile_copy's constants set to `values` for the block's calls."""
    old = {k: getattr(k11, k) for k in values}
    for k, v in values.items():
        setattr(k11, k, v)
    try:
        yield k11.copy_plan(dma.T, dma.W)
    finally:
        for k, v in old.items():
            setattr(k11, k, v)


def plans():
    """The constants of each distinct plan whose ring fits a block."""
    seen = set()
    for s in UNIT_ROWS:
        for r in RINGS:
            for bps in BLOCKS_PER_SM:
                values = {"UNIT_BYTES": s * dma.W * 4, "RING": r, "BLOCKS_PER_SM": bps}
                try:
                    with plan(**values) as p:
                        pass
                except ValueError:
                    continue  # the ring does not fit a block
                if p.ring == r and p not in seen:
                    seen.add(p)
                    yield values, p


def tag(p: k11.CopyPlan) -> str:
    return f"S={p.unit_rows} R={p.ring} blocks/SM={p.blocks_per_sm}"


def main() -> int:
    if not torch.cuda.is_available():
        print("copy_sweep: no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[copy_sweep] {smi or device_name(dev)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randint(-2**31, 2**31 - 1, (dma.N * dma.W // 128, 128), generator=gen,
                      dtype=torch.int32, device=dev)
    starts = torch.arange(dma.N // dma.T, dtype=torch.int32) * dma.T
    into = torch.empty_like(x)

    def copy_ms():
        return kernel_ms(lambda: into.copy_(x), ("",))

    def plan_ms(G):
        return kernel_ms(lambda: k11.tile_copy(x, starts, G, dma.T, dma.W), ("tile_copy",))

    print(f"[copy_sweep] n={dma.N} W={dma.W} T={dma.T}: copy_ {copy_ms():.4f} ms", flush=True)
    res = []
    for values, p in plans():
        with plan(**values):
            if not torch.equal(k11.tile_copy(x, starts, 32, dma.T, dma.W), x):
                raise AssertionError(f"copy_sweep: {p} is not a copy")
            ms = {G: plan_ms(G) for G in (32, dma.T)}
        res.append((ms[32], values, p))
        print(f"[copy_sweep] {tag(p)}: G=32 {ms[32]:.4f} ms, G={dma.T} {ms[dma.T]:.4f} ms",
              flush=True)
    for _, values, p in sorted(res, key=lambda r: r[0])[:10]:
        with plan(**values):
            pairs = [(plan_ms(32), copy_ms()) for _ in range(3)]
        print(f"[copy_sweep] in turns with copy_: {tag(p)}: G=32 "
              f"{statistics.median(q[0] for q in pairs):.4f} ms, copy_ "
              f"{statistics.median(q[1] for q in pairs):.4f} ms", flush=True)
    p = k11.copy_plan(dma.T, dma.W)
    for G in dma.GS:
        print(f"[copy_sweep] default {tag(p)}: G={G} {plan_ms(G):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
