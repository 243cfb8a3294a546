"""The over-budget route's tiled join timed on the card, for one or more
checkouts of the repository in turn (say a parent commit unpacked under
``build/`` and this tree: parent, change, change, parent).

Each checkout runs in a process of its own, with its own package and its own
kernel build: 24M + 24M rows from its ``chip_smoke.gen_pair`` (the bench's
key range), both sides through ``distinct``, then
``hash_join_count(s_d, r_d, 1, build_count=nu_s, probe_count=nu_r)``, the
tiled join of ``make_pipeline_staged(1)`` over the default 16M-row budget.
Printed a line a checkout: the device time of one call (torch.profiler,
mean of 5 calls), the median host wall of 7 synchronized calls, K9's and
K10's share of the device time, and nres (equal across checkouts).

    python -m database_technology_algorithms_tpu_torch.tools.tiled_join_ab ROOT [ROOT ...]
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# kernels of the staging (K9, on either design) and of the build multiplicity
K9_NAMES = ("cells_", "stage_", "onesweep")
K10_NAMES = ("member_mult",)


def one(root: str) -> dict:
    """Time the tiled join of the checkout at `root` (run in a fresh process
    whose working directory is `root`)."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from database_technology_algorithms_tpu_torch.config import DEFAULT_CONFIG as cfg
    from database_technology_algorithms_tpu_torch.kernels import build, library
    from database_technology_algorithms_tpu_torch.ops.distinct import distinct
    from database_technology_algorithms_tpu_torch.ops.hash_join import hash_join_count

    build()
    library()
    dev = torch.device("cuda")
    r_cols, s_cols = cs.gen_pair(cs.OVER_ROWS)
    r, s = cs.to_batch(r_cols, dev), cs.to_batch(s_cols, dev)
    r_d, nu_r = distinct(r, 1, cfg, active=r.valid)
    s_d, nu_s = distinct(s, 1, cfg, active=s.valid)
    del r, s

    def join():
        return hash_join_count(s_d, r_d, 1, cfg, build_count=nu_s, probe_count=nu_r)

    _, _, nres = join()
    prof = cs.profile_device(join, reps=5)
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        join()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    share = {"K9": 0.0, "K10": 0.0}
    for name, us in prof["top"]:
        if any(k in name for k in K9_NAMES):
            share["K9"] += us / 1e3
        elif any(k in name for k in K10_NAMES):
            share["K10"] += us / 1e3
    return {"root": root, "rows": cs.OVER_ROWS, "nres": int(nres),
            "device_ms": prof["busy_us"] / 1e3, "wall_ms": statistics.median(walls),
            "walls_ms": walls, "kernels_ms": share}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[tiled_join_ab] {smi}", flush=True)
    for root in argv:
        # this file, run as a script, imports the checkout's own package
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", root],
                             capture_output=True, text=True, cwd=Path(root).resolve())
        lines = out.stdout.strip().splitlines()
        if out.returncode or not lines:
            print(out.stdout[-2000:], out.stderr[-4000:])
            return 1
        print(f"[tiled_join_ab] {lines[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
