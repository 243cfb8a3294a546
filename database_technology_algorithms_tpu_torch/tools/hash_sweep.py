"""K16's plan (``kernels/engines_plan.hash_plan``) and K21's
(``kernels/dist_plan.in_set_plan``) swept on the card.

The inputs:

- K16: the build keys ``hash_join_count`` gives it under "table" at field 1
  on ``chip_smoke.gen_pair``'s tables (the bench's key range, about 70% of
  the keys duplicates) of 1M + 1M and 8M + 8M rows, recorded from those
  calls, and a build of 1M keys all equal.
- K21: shard 0's build hashes and hot list of the 4-shard skew join on
  BASELINE config 4's Zipf 1.2 tables (``chip_smoke.dist_cols``, 4M + 4M;
  128 entries, a few live), recorded from ``dist_hash_join_skew``, and the
  same hashes against a full list (``IN_SET_MAX_HOT`` entries of hashes
  that occur, a third live: search mode).

The sweep:

- K16: keys a thread (1, 2, 4, 8) by window (1 or 4 slots) at 256
  threads; threads a block (128, 512, 1024) at the constants' plan.
- K21: rows a thread (1, 2, 4, 8) by threads (64-512), the grid capped at
  132-1056 blocks (a thread takes several steps); on the full list rows a
  thread by search threads (256, 512, 1024).

Each plan is set through the plan modules' constants around ordinary
wrapper calls; the plans' numbers are kernel arguments, so one build serves
them all.  Every plan's result is held against the plain version (K16 by
its stored set, flag and failure count).  A time is the sum of the mean
device times of one call's launches (the fill included) over 10 calls in a
fenced trace (``chip_smoke.launches_in_order``), in ms, beside each
launch's own.
The ``HASH_*`` and ``IN_SET_*`` constants are the ones these readings chose.

    python -m database_technology_algorithms_tpu_torch.tools.hash_sweep
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import dist_plan, engines_plan
from . import device_name

KEYS = (1, 2, 4, 8)
WINDOWS = (1, 4)
HASH_THREADS = (128, 512, 1024)
ROWS = (1, 2, 4, 8)
IN_THREADS = (64, 128, 256, 512)
IN_BLOCKS = (132, 264, 528, 1056)
SEARCH_THREADS = (256, 512, 1024)


@contextlib.contextmanager
def plan(module, **values):
    """The module's constants set to `values` for the block's calls."""
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def show(launches: list) -> str:
    """A call's time as its launches' sum, beside each launch's."""
    return f"{sum(ms for _, ms in launches):.4f} ms (" + ", ".join(
        f"{name} {ms:.4f}" for name, ms in launches) + ")"


def k16_inputs(cs, dev) -> dict:
    """(keys, size, count, limit) of K16 by name."""
    import numpy as np

    # bound to the wrappers when first imported: before any recorder swaps one
    from database_technology_algorithms_tpu_torch.ops import hash_table  # noqa: F401
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count

    got = {}
    for rows in (cs.ROWS, cs.BIG_ROWS):
        r_cols, s_cols = cs.gen_pair(rows)
        r, s = cs.to_batch(r_cols, dev), cs.to_batch(s_cols, dev)
        with cs.recorded_calls("hash_set", "hash_set_build") as calls:
            hash_join_count(s, r, 1, cs.engine_cfg("table"))
        got[f"{rows} keys"] = calls[0][0]
    keys, size, count, limit = got[f"{cs.ROWS} keys"]
    got[f"{cs.ROWS} keys all equal"] = (cs.u32_dev(np.full(cs.ROWS, 77, np.uint32), dev), size,
                                        count, limit)
    return got


def k21_inputs(cs, dev) -> dict:
    """(hashes, hot) of K21 by name."""
    import numpy as np

    from database_technology_algorithms_tpu_torch.parallel import dist_ops, skew
    from database_technology_algorithms_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=[dev] * cs.DIST_SHARDS)
    zb, zp = cs.dist_cols(cs.DIST_ROWS, 44, zipf_a=1.2), cs.dist_cols(cs.DIST_ROWS, 45, zipf_a=1.2)
    zb["valid"][:] = True
    zp["valid"][:] = True
    tb, tp = dist_ops.distribute(mesh, zb), dist_ops.distribute(mesh, zp)
    with cs.recorded_calls("hot_set", "in_hot_set") as calls:
        skew.dist_hash_join_skew(mesh, tb, tp, 1)
    hh, hot = calls[0][0]
    g = np.random.default_rng(18)
    full = hh[torch.from_numpy(g.integers(0, hh.shape[0], dist_plan.IN_SET_MAX_HOT)).to(dev)]
    full[torch.from_numpy(g.random(full.shape[0]) < 2 / 3).to(dev)] = -1
    return {f"zipf shard 0, {hh.shape[0]} hashes, {hot.shape[0]} entries": (hh, hot),
            f"full list, {hh.shape[0]} hashes, {full.shape[0]} entries": (hh, full)}


def sweep_k16(cs, dev) -> None:
    from database_technology_algorithms_tpu_torch.kernels.hash_set import (
        hash_set_build, hash_set_build_plain)

    plans = [dict(HASH_KEYS=k, HASH_WINDOW=w) for k in KEYS for w in WINDOWS]
    plans += [dict(HASH_THREADS=t) for t in HASH_THREADS]
    plans += [{}]
    for what, args in k16_inputs(cs, dev).items():
        want = cs.hash_set_parts(hash_set_build_plain(*args))
        for values in plans:
            with plan(engines_plan, **values):
                if cs.max_abs_err(cs.hash_set_parts(hash_set_build(*args)), want):
                    raise AssertionError(f"hash_sweep: K16 under {values} differs from the plain "
                                         f"version on {what}")
                t = cs.launches_in_order(lambda: hash_set_build(*args))
                shown = values or engines_plan.hash_plan(args[0].shape[0], args[1],
                                                         args[0].data_ptr())
            print(f"[hash_sweep] K16 {what} into {args[1]} slots: {shown}: {show(t)}", flush=True)


def sweep_k21(cs, dev) -> None:
    from database_technology_algorithms_tpu_torch.kernels.hot_set import (
        in_hot_set, in_hot_set_plain)

    for what, (hh, hot) in k21_inputs(cs, dev).items():
        want = in_hot_set_plain(hh, hot)
        if hot.shape[0] > dist_plan.IN_SET_SCAN_MAX:
            plans = [dict(IN_SET_ROWS=r, IN_SET_SEARCH_THREADS=t)
                     for r in ROWS for t in SEARCH_THREADS]
        else:
            plans = [dict(IN_SET_ROWS=r, IN_SET_THREADS=t) for r in ROWS for t in IN_THREADS]
            plans += [dict(IN_SET_BLOCKS=b) for b in IN_BLOCKS]
        for values in plans + [{}]:
            with plan(dist_plan, **values):
                if not torch.equal(in_hot_set(hh, hot), want):
                    raise AssertionError(f"hash_sweep: K21 under {values} differs from the "
                                         f"plain version on {what}")
                t = cs.launches_in_order(lambda: in_hot_set(hh, hot))
                shown = values or dist_plan.in_set_plan(hh.shape[0], hot.shape[0],
                                                        hh.data_ptr(), 0)
            print(f"[hash_sweep] K21 {what}: {shown}: {show(t)}", flush=True)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("hash_sweep: no CUDA device")
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[hash_sweep] {smi or device_name(dev)}", flush=True)
    parts = argv or ["k16", "k21"]
    if "k16" in parts:
        sweep_k16(cs, dev)
    if "k21" in parts:
        sweep_k21(cs, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
