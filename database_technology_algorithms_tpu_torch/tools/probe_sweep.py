"""K15's and K18's plans (``kernels/engines_plan.py``) swept on the card.

The inputs are the ones ``hash_join_count`` gives the two kernels at field 1
on ``chip_smoke.gen_pair``'s tables (the bench's key range) of 1M + 1M and
8M + 8M rows, under the "searchsorted" (K15) and "bucketed" (K18) engines,
recorded from those calls.

- K15: the index tree's levels (12-15: 2^levels - 1 keys, 16-128 KiB of
  shared memory a block), threads a block (256, 512, 1024) and blocks an
  SM (1, 2, 4, at most those that fit).
- K18: buckets a compare block (4, 8, 16, 32) and threads a block (128,
  256, 512).

Each plan is set through ``engines_plan``'s constants around ordinary
wrapper calls; the plans' numbers are kernel arguments, so one build serves
them all.  Every plan's result is held against the plain version.  A time is
the sum of the median device times of one call's launches (its memset
included) over ``scan_sweep.REPS`` calls (torch.profiler), in ms, beside
each launch's own.
``engines_plan``'s PROBE_* and BUCKET_* constants are the ones these readings
chose.

    python -m database_technology_algorithms_tpu_torch.tools.probe_sweep
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import engines_plan as plan_mod
from . import device_name
from .scan_sweep import kernel_ms

LEVELS = (12, 13, 14, 15)
THREADS = (256, 512, 1024)
BLOCKS_PER_SM = (1, 2, 4)
SPANS = (4, 8, 16, 32)
BUCKET_THREADS = (128, 256, 512)
K15_LAUNCHES = ("index_kernel", "search_kernel")
K18_LAUNCHES = ("Memset", "starts_kernel", "compare_kernel")


@contextlib.contextmanager
def plan(**values):
    """engines_plan's constants set to `values` for the block's calls."""
    old = {k: getattr(plan_mod, k) for k in values}
    for k, v in values.items():
        setattr(plan_mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(plan_mod, k, v)


def recorded_inputs(cs, rows: int, dev) -> dict:
    """The arguments of K15 and K18 in ``hash_join_count`` at field 1 on
    rows + rows, under the engines that call them."""
    from database_technology_algorithms_tpu_torch.ops import bucket_join, fastpath  # noqa: F401
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count

    r_cols, s_cols = cs.gen_pair(rows)
    r, s = cs.to_batch(r_cols, dev), cs.to_batch(s_cols, dev)
    got = {}
    for name, engine in (("sorted_probe", "searchsorted"), ("bucket_probe", "bucketed")):
        with cs.recorded_calls(name, name) as calls:
            hash_join_count(s, r, 1, cs.engine_cfg(engine))
        got[name] = calls[0][0]
    return got


def timed(fn, launches: tuple) -> dict:
    """Each launch's median device time, and their sum as the call's."""
    out = {name: kernel_ms(fn, (name,)) for name in launches}
    return {"call": sum(out.values()), **out}


def show(t: dict) -> str:
    return f"{t['call']:.4f} ms (" + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items() if k != "call") + ")"


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_sweep: no CUDA device")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs
    from database_technology_algorithms_tpu_torch.kernels.bucket_probe import (
        bucket_probe, bucket_probe_plain)
    from database_technology_algorithms_tpu_torch.kernels.sorted_probe import (
        sorted_probe, sorted_probe_plain)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[probe_sweep] {smi or device_name(dev)}", flush=True)
    for rows in (cs.ROWS, cs.BIG_ROWS):
        args = recorded_inputs(cs, rows, dev)
        k15, k18 = args["sorted_probe"], args["bucket_probe"]
        want15 = sorted_probe_plain(*k15)
        want18 = bucket_probe_plain(*k18)
        tag = f"{rows} + {rows}"
        for levels in LEVELS:
            for threads in THREADS:
                for bps in BLOCKS_PER_SM:
                    values = {"PROBE_LEVELS": levels, "PROBE_THREADS": threads,
                              "PROBE_BLOCKS_PER_SM": bps}
                    with plan(**values):
                        p = plan_mod.probe_plan(k15[0].shape[0])
                        if p.blocks_per_sm != bps:
                            continue  # fewer fit an SM: another plan's point
                        if not all(torch.equal(a, b) for a, b in zip(sorted_probe(*k15),
                                                                     want15)):
                            raise AssertionError(f"probe_sweep: K15 under {values} differs "
                                                 f"from the plain version")
                        t = timed(lambda: sorted_probe(*k15), K15_LAUNCHES)
                    print(f"[probe_sweep] K15 {tag}: levels={levels} threads={threads} "
                          f"blocks/SM={bps}: {show(t)}", flush=True)
        t = timed(lambda: sorted_probe(*k15), K15_LAUNCHES)
        print(f"[probe_sweep] K15 {tag}: default {plan_mod.probe_plan(k15[0].shape[0])}: "
              f"{show(t)}", flush=True)
        for span in SPANS:
            for threads in BUCKET_THREADS:
                with plan(BUCKET_SPAN=span, BUCKET_THREADS=threads):
                    got = bucket_probe(*k18)
                    if not all(torch.equal(a, b) for a, b in zip(got, want18)):
                        raise AssertionError(f"probe_sweep: K18 at span {span}, {threads} "
                                             f"threads differs from the plain version")
                    t = timed(lambda: bucket_probe(*k18), K18_LAUNCHES)
                print(f"[probe_sweep] K18 {tag}: span={span} threads={threads}: {show(t)}",
                      flush=True)
        t = timed(lambda: bucket_probe(*k18), K18_LAUNCHES)
        print(f"[probe_sweep] K18 {tag}: default {plan_mod.bucket_plan()}: {show(t)}",
              flush=True)
        del args, k15, k18, want15, want18
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
