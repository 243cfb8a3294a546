"""The rows a block of the row-move engine owns, swept on the card (K4, K12).

Times K4 (``take_fill``) and K12 (``row_move``) at the main paths' shapes
and at the over-budget route's and the probe's, with every block of 32 to
1024 rows forced in turn and with the span ``kernels/rowmove_plan.py``
picks, which these readings chose: large spans where a call's rows fit in
the 50 MB L2 cache, small ones beyond it.  A time is the kernel's median
device time over 20 calls (torch.profiler), in ms; inputs are random, made
on the card from a seed.

    python -m database_technology_algorithms_tpu_torch.tools.rowmove_sweep
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess

import torch

from ..kernels import rowmove_plan
from ..kernels.row_move import row_move
from ..kernels.take_fill import take_fill
from . import device_name

SPANS = (32, 64, 128, 256, 512, 1024)
REPS = 20


def kernel_ms(fn, name: str) -> float:
    """Median device time of the kernels named `name` over REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    times = [ev.device_time for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and name in ev.name]
    if not times:
        raise RuntimeError(f"rowmove_sweep: torch.profiler saw no {name} kernel")
    return statistics.median(times) / 1e3


@contextlib.contextmanager
def forced_span(rows: int | None):
    """Every launch inside owns `rows` rows a block (None: the plan's span)."""
    chosen = rowmove_plan.block_rows
    if rows is not None:
        rowmove_plan.block_rows = lambda row_vectors, footprint: rows
    try:
        yield
    finally:
        rowmove_plan.block_rows = chosen


def shapes(dev) -> list[tuple[str, str, object]]:
    g = torch.Generator(device=dev).manual_seed(5)

    def words(*shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev, generator=g)

    def k4(n, m, live, k=2):
        cols = (words(n), words(n), words(n, k), torch.rand(n, device=dev, generator=g) < 0.9)
        idx = torch.randperm(n, device=dev, generator=g)[:m].to(torch.int32)
        cnt = torch.tensor(live, dtype=torch.int32, device=dev)
        return lambda: take_fill(*cols, idx, cnt)

    def k12(n, w, tile, load, live=None):
        x = words(n, w)
        slot = torch.cat([torch.randperm(min(tile, n - t0), device=dev, generator=g)
                          for t0 in range(0, n, tile)]).to(torch.int32)
        cnt = None if live is None else torch.tensor(live, dtype=torch.int32, device=dev)
        return lambda: row_move(x, slot, tile, load, cnt)

    mi = 1_000_000
    return [
        ("K4 1M x (3+2), 279043 live (staged run)", "take_fill", k4(mi, mi, 279_043)),
        ("K4 1M x (3+2), all live", "take_fill", k4(mi, mi, mi)),
        ("K4 1M x (3+8), all live", "take_fill", k4(mi, mi, mi, 8)),
        ("K4 16M of 24M x (3+2) (over-budget chunk)", "take_fill",
         k4(24_000_000, 16 * 2**20, 16 * 2**20)),
        ("K12 load 1M x 5, 279043 live (sort2d stage B)", "row_move", k12(mi, 5, mi, True, 279_043)),
        ("K12 load 16M x 5", "row_move", k12(16 * 10**6, 5, 16 * 10**6, True)),
        ("K12 load 2^20 x 36, tile 2048 (P5)", "row_move", k12(2**20, 36, 2048, True)),
        ("K12 store 2^20 x 36, tile 2048 (P4)", "row_move", k12(2**20, 36, 2048, False)),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("rowmove_sweep: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip().splitlines()
    print(f"rowmove_sweep on {device_name(dev)}, {limit[0] if limit else 'power limit unread'}: "
          f"kernel ms by rows a block")
    print("shape | " + " | ".join(str(s) for s in SPANS) + " | plan")
    for label, name, fn in shapes(dev):
        row = []
        for span in (*SPANS, None):
            with forced_span(span):
                row.append(f"{kernel_ms(fn, name):.4f}")
        print(f"{label} | " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
