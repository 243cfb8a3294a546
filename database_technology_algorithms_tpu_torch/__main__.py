"""CLI driver of the PyTorch port.

Ported so far: the ``mergejoin`` subcommand, in budget — sort-merge join
two reference-format block files (distinct-key intersection), write the
matched R rows in key order, and print a stats JSON line:

    python -m database_technology_algorithms_tpu_torch mergejoin \\
        file1.bin file2.bin out.bin --field 1 [--device cpu]

It runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _blockfile_rows(path: str) -> int:
    from .batch import MAX_RECORDS_PER_BLOCK
    from .io.blockfile import BLOCK_SIZE

    return (os.path.getsize(path) // BLOCK_SIZE) * MAX_RECORDS_PER_BLOCK


def cmd_mergejoin(args) -> int:
    from .batch import canonical_field
    from .config import DEFAULT_CONFIG
    from .io.blockfile import read_blockfile, write_blockfile
    from .models.pipeline import make_pipeline_staged
    from .ops.filter import truncate
    from .utils.checks import ensure_device_budget, resolve_device

    device = resolve_device(args.device)
    field = canonical_field(args.field)
    if args.mem_blocks:
        raise NotImplementedError(
            "--mem-blocks: the external (bounded-memory) route is not ported yet"
        )
    rows = _blockfile_rows(args.infile1) + _blockfile_rows(args.infile2)
    ensure_device_budget(rows, DEFAULT_CONFIG, "mergejoin")
    run = make_pipeline_staged(field)
    r = read_blockfile(args.infile1, device=device)
    s = read_blockfile(args.infile2, device=device)
    t0 = time.time()
    out = run(r, s)
    nres = int(out["merge_nres"])
    write_blockfile(args.outfile, truncate(out["join_out"], nres))
    print(
        json.dumps(
            {
                "nres": nres,
                "nunique_r": int(out["nunique_r"]),
                "nunique_s": int(out["nunique_s"]),
                "wall_s": round(time.time() - t0, 4),
            }
        )
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="database_technology_algorithms_tpu_torch",
        description="query engine, PyTorch/CUDA port (reference-parity CLI)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    mj = sub.add_parser("mergejoin", help="sort-merge join two block files")
    mj.add_argument("infile1")
    mj.add_argument("infile2")
    mj.add_argument("outfile")
    mj.add_argument("--field", default="1")
    mj.add_argument("--mem-blocks", type=int, default=0,
                    help="bounded-memory mode (not ported yet: nonzero raises)")
    mj.add_argument("--workdir", default=".",
                    help="spill directory of the bounded-memory mode")
    mj.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    mj.set_defaults(fn=cmd_mergejoin)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
