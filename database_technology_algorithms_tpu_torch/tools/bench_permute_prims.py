"""Permute probe: the candidate primitives for a record-permute engine.

The counterpart of the repository's ``tools/bench_permute_prims.py``:

- P1, a replicated-key 2-D sort: each column of a [N, G] key (G copies of a
  permutation of N) sorted along dim 0 with its payload columns, as
  ``lax.sort((key, payload...), num_keys=1, dimension=0)``; here
  ``torch.sort`` and a gather of each payload by its indices.  It prints the
  time of a call and what 35 words would cost at G x payloads words a call.
- P2 and P3, a one-hot permutation of TB = 64 tiles of T rows x 144 u8
  columns into S = 2T slots as a batched product ``[TB, S, T] @ [TB, T,
  144]``: in bf16 with f32 accumulation (``torch.bmm``; the output is bf16,
  exact here, since each output is one term) and in int8 with int32
  accumulation (``torch._int_mm``, one call a tile: it takes 2-D operands).
  It prints the time of a call as the JAX probe times it (the one-hot built
  from the slots inside the call), multiply-adds a second, rows a second,
  the product alone and its share of the card's tensor-core peak for the
  type (``utils/roofline.py``), and the cost of a pass over N rows.
- P4 and P5, rows of W = 36 u32 words moved within tiles of T rows by
  tile-relative slots, one random permutation a tile: P5 gathers
  (``out[j] = x[slot[j]]``), P4 scatters (``out[slot[j]] = x[j]``), through
  K12 (``kernels/row_move.py``).

P1-P3 time library calls, as the JAX probe times XLA operations: they are
measurements of the card, not kernels of the port.  Every line names the
card and its power limit.

    python -m database_technology_algorithms_tpu_torch.tools.bench_permute_prims [--cpu] [P1 P4 ...]

``--cpu`` runs tiny shapes (N = 2^14, T = 512, 4 tiles) against numpy, for
correctness only.
"""

from __future__ import annotations

import math
import subprocess
import sys

import numpy as np
import torch

from ..kernels.row_move import row_move
from ..utils import roofline
from ..utils.checks import resolve_device
from . import cuda_ms, device_name

N = 1 << 20
W = 36
T = 2048  # rows per tile
C4 = W * 4  # u8 columns of a row
TB = 64  # tiles of a one-hot product
P1_SHAPES = ((4, 1), (8, 1), (8, 2), (16, 1), (16, 2), (32, 1))  # (key copies G, payloads)
PLACE_WORDS = 35  # the words of a record that the permute engine moves


def make_rowmove(load: bool, tile: int = T):
    """``f(x, slot)``: the per-row gather (``load``, P5) or scatter (P4) of
    x int32 [N, W] by tile-relative slots int32 [N]."""

    def f(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        return row_move(x, slot, tile, load)

    return f


def sort2d(key: torch.Tensor, *pays: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """P1: each payload [N, G] with its column sorted by the same column of
    `key` [N, G] (stably, keys as int32 values), as ``lax.sort((key,) +
    pays, num_keys=1, dimension=0)[1:]``."""
    idx = torch.sort(key, dim=0, stable=True).indices
    return tuple(p.gather(0, idx) for p in pays)


def onehot(slot: torch.Tensor, s: int) -> torch.Tensor:
    """bool [TB, s, T]: ``slot[b, j] == p`` at [b, p, j]."""
    return slot[:, None, :] == torch.arange(s, dtype=slot.dtype, device=slot.device)[None, :, None]


def onehot_mm(oh: torch.Tensor, x: torch.Tensor, int8: bool) -> torch.Tensor:
    """The batched product of one-hot [TB, S, T] and u8 rows [TB, T, C]:
    bf16 (P2) or int8 with int32 sums (P3), back to u8."""
    if int8:
        ohm, xm = oh.to(torch.int8), x.to(torch.int8)
        y = torch.stack([torch._int_mm(ohm[b], xm[b]) for b in range(x.shape[0])])
        return (y & 0xFF).to(torch.uint8)
    return torch.bmm(oh.to(torch.bfloat16), x.to(torch.bfloat16)).to(torch.uint8)


def onehot_permute(x: torch.Tensor, slot: torch.Tensor, s: int, int8: bool) -> torch.Tensor:
    """P2/P3: ``out[b, slot[b, j]] = x[b, j]`` (rows of u8 [TB, T, C]; slots
    int32 [TB, T], distinct in [0, s) a tile; zero rows elsewhere) as the
    JAX probe computes it, a one-hot product."""
    return onehot_mm(onehot(slot, s), x, int8)


def tile_slots(n: int, tile: int, seed: int = 0) -> np.ndarray:
    """One random permutation of [0, tile) a tile, flattened (int32)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.permutation(tile) for _ in range(n // tile)]).astype(np.int32)


def p1_inputs(n: int, g: int, npay: int, seed: int = 0) -> tuple[np.ndarray, list]:
    """A permutation of n replicated into [n, g], and `npay` random [n, g]
    payloads below 2^30 (int32)."""
    rng = np.random.default_rng(seed)
    key = np.broadcast_to(rng.permutation(n).astype(np.int32)[:, None], (n, g))
    return np.ascontiguousarray(key), [rng.integers(0, 1 << 30, (n, g), dtype=np.int32)
                                      for _ in range(npay)]


def p23_inputs(tb: int, tile: int, seed: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """u8 rows [tb, tile, C4] (0-254) and, a tile, `tile` distinct slots of 2 * tile."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 255, (tb, tile, C4), dtype=np.uint8)
    slot = np.stack([rng.permutation(2 * tile)[:tile] for _ in range(tb)]).astype(np.int32)
    return x, slot


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return smi or device_name(dev)


def p1(n: int, dev: torch.device, card: str) -> None:
    for g, npay in P1_SHAPES:
        key, pays = p1_inputs(n, g, npay)
        kd = torch.from_numpy(key).to(dev)
        pd = [torch.from_numpy(p).to(dev) for p in pays]
        name = f"P1 sort2d [N,{g}]x{npay}pay"
        if dev.type == "cpu":
            order = np.argsort(key[:, 0], kind="stable")
            ok = all(np.array_equal(o.numpy(), p[order]) for o, p in zip(sort2d(kd, *pd), pays))
            print(f"{name} ok={ok}", flush=True)
            continue
        per = cuda_ms(lambda: sort2d(kd, *pd))
        eq35 = per * math.ceil(PLACE_WORDS / (g * npay))
        print(f"{name:28s} {per:9.4f} ms  -> {PLACE_WORDS} words = {eq35:.4f} ms  [{card}]",
              flush=True)


def p23(int8: bool, n: int, tile: int, tb: int, dev: torch.device, card: str) -> None:
    kind = "int8" if int8 else "bf16"
    name = f"P{'3' if int8 else '2'} onehot-mm {kind}"
    s = 2 * tile
    x, slot = p23_inputs(tb, tile)
    xd, sd = torch.from_numpy(x).to(dev), torch.from_numpy(slot).to(dev)
    if dev.type == "cpu":
        ref = np.zeros((tb, s, C4), np.uint8)
        for b in range(tb):
            ref[b, slot[b]] = x[b]
        out = onehot_permute(xd, sd, s, int8).numpy()
        print(f"{name} ok={bool(np.array_equal(out, ref))}", flush=True)
        return
    per = cuda_ms(lambda: onehot_permute(xd, sd, s, int8))
    oh = onehot(sd, s)
    mm = cuda_ms(lambda: onehot_mm(oh, xd, int8))
    macs = tb * s * tile * C4
    peak = roofline.chip_tensor_ops_per_s(kind, dev)
    print(f"{name:28s} {per:9.4f} ms  {macs / per / 1e9:.1f} Tmac/s  "
          f"{tb * tile / per * 1e3:.4g} rows/s; the product alone {mm:.4f} ms, "
          f"{100 * 2 * macs / (mm / 1e3) / peak:.2f}% of the {kind} tensor peak "
          f"({peak / 1e12:.0f} Top/s) -> a {n}-row pass = {per * n / (tb * tile):.4f} ms  "
          f"[{card}]", flush=True)


def p45(load: bool, n: int, tile: int, dev: torch.device, card: str) -> None:
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
    print(f"{name:28s} {per:9.4f} ms  {per * 1e6 / n:.3f} ns/row  [{card}]", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    n, tile, tb = (1 << 14, 512, 4) if cpu else (N, T, TB)
    dev = resolve_device("cpu" if cpu else None)
    card = card_line(dev)
    print(f"device={card} N={n} T={tile}", flush=True)
    which = [a for a in argv if not a.startswith("--")] or ["P1", "P2", "P3", "P4", "P5"]
    for p in which:
        if p == "P1":
            p1(n, dev, card)
        elif p in ("P2", "P3"):
            p23(p == "P3", n, tile, tb, dev, card)
        elif p in ("P4", "P5"):
            p45(p == "P5", n, tile, dev, card)
        else:
            print(f"{p}: no such measurement (P1-P5)", flush=True)
            return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
