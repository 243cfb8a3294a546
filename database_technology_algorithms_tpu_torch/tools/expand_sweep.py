"""K14's plan (``kernels/scan_plan.expand_plan``) swept on the card.

The inputs, each ``(c, total, cap)`` of ``expand_sources``:

- the field-3 shape: what ``materialize_field3_device`` gives K14 on
  ``chip_smoke``'s field-3 join (``checkout_ab.field3_join``: 1M build and
  1M probe rows, multiplicities up to tens), at cap = total;
- the heavy-row shape: 1M probe rows, one of which holds all of 1M outputs;
- the all-zero shape: 1M probe rows of multiplicity 0 and a capacity of 1M
  rows, every output the fill row.

The sweep: threads a block (64-512) by merge items a thread (4-16; the odd
counts leave the merge's shared-memory strides free of bank conflicts), set
through ``scan_plan``'s constants around ordinary wrapper calls; the plan's
numbers are kernel arguments, so one build serves them all.  Every plan's
result is held against the plain version.  A time is the median device time
of the kernel over 20 calls (``scan_sweep.kernel_ms``), in ms.  The
``EXPAND_*`` constants are the ones these readings chose.

    python -m database_technology_algorithms_tpu_torch.tools.expand_sweep
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import scan_plan
from . import device_name

THREADS = (64, 128, 256, 512)
ITEMS = (4, 7, 8, 11, 15, 16)
# (threads, items) of every plan the sweep tries
PLANS = [(t, v) for t in THREADS for v in ITEMS]
ROWS = 1 << 20


def inputs(cs, dev) -> dict:
    """(c, total, cap) of K14 by shape."""
    from database_technology_algorithms_tpu_torch.ops.hash_join import materialize_field3_device

    from .checkout_ab import field3_join

    probe, mult, total = field3_join(cs, dev)
    with cs.recorded_calls("expand_sources", "expand_sources") as calls:
        materialize_field3_device(probe, mult, total)
    c, t, cap = calls[0][0]
    got = {f"field 3, {c.shape[0]} probe rows -> {cap} outputs": (c, t, cap)}
    heavy = torch.zeros(ROWS, dtype=torch.int32, device=dev)
    heavy[ROWS // 3] = ROWS
    for what, mult in ((f"one row of {ROWS} holds all {ROWS} outputs", heavy),
                       (f"{ROWS} rows of multiplicity 0, cap {ROWS}",
                        torch.zeros(ROWS, dtype=torch.int32, device=dev))):
        c = torch.cumsum(mult, 0, dtype=torch.int32)
        got[what] = (c, c[-1], ROWS)
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("expand_sweep: no CUDA device")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    from ..kernels.expand_sources import expand_sources, expand_sources_plain
    from .hash_sweep import plan
    from .scan_sweep import kernel_ms

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[expand_sweep] {smi or device_name(dev)}", flush=True)
    for what, (c, total, cap) in inputs(cs, dev).items():
        want = expand_sources_plain(c, total, cap)
        for threads, items in PLANS:
            with plan(scan_plan, EXPAND_THREADS=threads, EXPAND_ITEMS=items):
                if not torch.equal(expand_sources(c, total, cap), want):
                    raise AssertionError(f"expand_sweep: K14 at {threads} threads x {items} "
                                         f"items differs from the plain version on {what}")
                ms = kernel_ms(lambda: expand_sources(c, total, cap), ("expand_sources",))
            print(f"[expand_sweep] K14 {what}: {threads} threads x {items} items "
                  f"({threads * items} a block): {ms:.4f} ms", flush=True)
        print(f"[expand_sweep] K14 {what}: the plan {scan_plan.expand_plan(cap, c.shape[0])}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
