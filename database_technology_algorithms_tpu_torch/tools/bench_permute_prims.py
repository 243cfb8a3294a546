"""Row-move probe: per-row gather and scatter within tiles (K12).

The counterpart of the P4 and P5 measurements of the repository's
``tools/bench_permute_prims.py``: rows of W = 36 u32 words move within tiles
of T rows by tile-relative slots, one random permutation a tile.
P5 gathers (``out[j] = x[slot[j]]``), P4 scatters (``out[slot[j]] = x[j]``).
P1-P3 there measure XLA primitives (a replicated-key 2-D sort and one-hot
matrix products), not Pallas kernels, and are not ported; asked for, they
print so.

    python -m database_technology_algorithms_tpu_torch.tools.bench_permute_prims [--cpu] [P4 P5 ...]

``--cpu`` runs the plain version at N = 2^14, T = 512, for correctness only.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..kernels.row_move import row_move
from ..utils.checks import resolve_device
from . import cuda_ms, device_name

N = 1 << 20
W = 36
T = 2048  # rows per tile


def make_rowmove(load: bool, tile: int = T):
    """``f(x, slot)``: the per-row gather (``load``, P5) or scatter (P4) of
    x int32 [N, W] by tile-relative slots int32 [N]."""

    def f(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        return row_move(x, slot, tile, load)

    return f


def tile_slots(n: int, tile: int, seed: int = 0) -> np.ndarray:
    """One random permutation of [0, tile) a tile, flattened (int32)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.permutation(tile) for _ in range(n // tile)]).astype(np.int32)


def p45(load: bool, n: int, tile: int, dev: torch.device) -> None:
    name = f"P{'5' if load else '4'} row-{'load' if load else 'store'}"
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(0, 1 << 30, (n, W), generator=gen, dtype=torch.int32)
    slot = tile_slots(n, tile)
    f = make_rowmove(load, tile)
    if dev.type == "cpu":
        xs = x.numpy().reshape(n // tile, tile, W)
        sl = slot.reshape(n // tile, tile)
        ref = np.zeros_like(xs)
        for t in range(n // tile):
            if load:
                ref[t] = xs[t][sl[t]]
            else:
                ref[t][sl[t]] = xs[t]
        out = f(x, torch.from_numpy(slot)).numpy()
        print(f"{name} plain ok={bool((out.reshape(ref.shape) == ref).all())}", flush=True)
        return
    xd, sd = x.to(dev), torch.from_numpy(slot).to(dev)
    per = cuda_ms(lambda: f(xd, sd))
    print(f"{name:28s} {per:9.4f} ms  {per * 1e6 / n:.3f} ns/row", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    n, tile = (1 << 14, 512) if cpu else (N, T)
    dev = resolve_device("cpu" if cpu else None)
    print(f"device={device_name(dev)} N={n} T={tile}", flush=True)
    which = [a for a in argv if not a.startswith("--")] or ["P1", "P2", "P3", "P4", "P5"]
    for p in which:
        if p in ("P4", "P5"):
            p45(p == "P5", n, tile, dev)
        else:
            print(f"{p}: an XLA primitive measurement, not a Pallas kernel: not ported",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
