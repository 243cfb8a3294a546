"""Command line of the PyTorch port — the heir of the reference's benchmark
program (``main.cpp:20-136``), with the JAX package's subcommands:

    pipeline   generate two tables, MergeJoin + HashJoin, cross-check counts
               (the reference main.cpp flow; also what a bare invocation runs)
    elimdup    DISTINCT a block file
    mergejoin  sort-merge join two block files (distinct-key intersection)
    hashjoin   hash semi-join two block files (probe-side rows)
    mergesort  external sort of a block file: not ported yet, raises

    python -m database_technology_algorithms_tpu_torch --nblocks 10000 --field 1 --skip-files
    python -m database_technology_algorithms_tpu_torch mergejoin f1.bin f2.bin out.bin --field 1

All commands read and write the reference's binary block format, print a
stats JSON line, and run on the card unless ``--device cpu`` is given.
The ``pipeline`` command's generated tables take the library routes at any
size: beyond the device budget (``EngineConfig.mem_rows``) ``distinct`` goes
through the chunked passes and ``hash_join`` through the tiled join.  Block
files beyond the budget belong to the external operators, which are not ported
yet: the file commands raise ``MemoryBudgetError`` for them, and the flags of
the bounded-memory and distributed routes (``--mem-blocks``, ``--dist``)
raise ``NotImplementedError``.
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


def _in_budget_only(args, op: str, *paths) -> None:
    """The file commands run in the device budget only."""
    from .config import DEFAULT_CONFIG
    from .utils.checks import ensure_device_budget

    if args.mem_blocks:
        raise NotImplementedError(
            "--mem-blocks: the external (bounded-memory) route is not ported yet "
            "(ROADMAP.md, Queue 1 item 9)"
        )
    ensure_device_budget(sum(_blockfile_rows(p) for p in paths), DEFAULT_CONFIG, op)


def cmd_pipeline(args) -> int:
    from .batch import canonical_field
    from .config import DEFAULT_CONFIG as cfg
    from .io.blockfile import read_blockfile, write_blockfile
    from .io.generator import generate_batch, generate_pair_files
    from .ops.distinct import distinct
    from .ops.filter import truncate
    from .ops.hash_join import hash_join
    from .ops.merge_join import join_sorted_distinct
    from .utils.checks import resolve_device

    if args.dist:
        raise NotImplementedError(
            "--dist: the distributed plan is not ported yet (ROADMAP.md, Queue 1 item 11)"
        )
    device = resolve_device(args.device)
    field = canonical_field(args.field)
    t0 = time.time()
    print(f"[gen] {args.nblocks} blocks x 2 files ({args.nblocks * 100} rows each)")
    if args.skip_files:
        r = generate_batch(args.nblocks, seed=args.seed, device=device)
        s = generate_batch(args.nblocks, seed=args.seed + 1, device=device)
    else:
        f1 = os.path.join(args.workdir, "file.bin")
        f2 = os.path.join(args.workdir, "file2.bin")
        generate_pair_files(f1, f2, args.nblocks, seed=args.seed)
        r, s = read_blockfile(f1, device=device), read_blockfile(f2, device=device)
    print(f"[gen] done in {time.time() - t0:.2f}s on {device.type}")

    print("\n--------------MERGE JOIN-------------------")
    t1 = time.time()
    r_d, nu_r = distinct(r, field, cfg)
    s_d, nu_s = distinct(s, field, cfg)
    out, nres = join_sorted_distinct(r_d, nu_r, s_d, nu_s, field, cfg)
    nres = int(nres)
    dt = time.time() - t1
    print(f"UNIQUE R: {int(nu_r)}  UNIQUE S: {int(nu_s)}")
    print(f"PAIRS IN THE OUTPUT: {nres} OUT OF {r.nrows}")
    print(f"[mergejoin] {dt:.3f}s  ({r.nrows / dt:,.0f} rows/s)")
    if not args.skip_files:
        write_blockfile(os.path.join(args.workdir, "outmerge.bin"), truncate(out, nres))

    print("\n--------------HASH JOIN-------------------")
    t2 = time.time()
    r_dt, s_dt = truncate(r_d, nu_r), truncate(s_d, nu_s)
    hout, hres = hash_join(r_dt, s_dt, field, cfg)
    hres = int(hres)
    dt2 = time.time() - t2
    print(f"PAIRS IN THE OUTPUT: {hres} OUT OF {s.nrows}")
    print(f"[hashjoin] {dt2:.3f}s  ({s_dt.nrows / dt2:,.0f} probe rows/s)")
    if not args.skip_files:
        write_blockfile(os.path.join(args.workdir, "outhash.bin"), truncate(hout, hres))

    agree = nres == hres
    print(
        "\n"
        + json.dumps(
            {
                "nblocks": args.nblocks,
                "field": field,
                "merge_join_pairs": nres,
                "hash_join_pairs": hres,
                "joins_agree": agree,
                "nunique_r": int(nu_r),
                "nunique_s": int(nu_s),
            }
        )
    )
    if not agree:
        print("ERROR: join counts disagree (reference oracle violated)")
        return 1
    return 0


def cmd_mergesort(args) -> int:
    raise NotImplementedError(
        "mergesort: the external sort is not ported yet (ROADMAP.md, Queue 1 item 9)"
    )


def cmd_elimdup(args) -> int:
    from .batch import canonical_field
    from .io.blockfile import read_blockfile, write_blockfile
    from .ops.distinct import distinct
    from .ops.filter import truncate
    from .utils.checks import resolve_device

    device = resolve_device(args.device)
    field = canonical_field(args.field)
    _in_budget_only(args, "elimdup", args.infile)
    batch = read_blockfile(args.infile, device=device)
    t0 = time.time()
    out, nunique = distinct(batch, field)
    nunique = int(nunique)
    write_blockfile(args.outfile, truncate(out, nunique))
    print(
        json.dumps(
            {"nunique": nunique, "rows": batch.nrows, "wall_s": round(time.time() - t0, 4)}
        )
    )
    return 0


def cmd_mergejoin(args) -> int:
    from .batch import canonical_field
    from .io.blockfile import read_blockfile, write_blockfile
    from .models.pipeline import make_pipeline_staged
    from .ops.filter import truncate
    from .utils.checks import resolve_device

    device = resolve_device(args.device)
    field = canonical_field(args.field)
    _in_budget_only(args, "mergejoin", args.infile1, args.infile2)
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


def cmd_hashjoin(args) -> int:
    """Hash semi-join two block files; matched probe rows go out in probe
    scan order (like the reference's probe loop,
    ``DatabaseProject.cpp:583-629``), and the JSON line says so."""
    from .batch import canonical_field
    from .io.blockfile import read_blockfile, write_blockfile
    from .ops.filter import truncate
    from .ops.hash_join import hash_join, hash_join_count, materialize_field3
    from .utils.checks import resolve_device

    device = resolve_device(args.device)
    field = canonical_field(args.field)
    _in_budget_only(args, "hashjoin", args.infile1, args.infile2)
    build = read_blockfile(args.infile1, device=device)
    probe = read_blockfile(args.infile2, device=device)
    t0 = time.time()
    if field == 3:
        matched, mult, nres = hash_join_count(build, probe, field)
        write_blockfile(args.outfile, materialize_field3(probe, matched, mult))
        nres = int(nres)
    else:
        out, nres = hash_join(build, probe, field)
        nres = int(nres)
        write_blockfile(args.outfile, truncate(out, nres))
    print(json.dumps({
        "nres": nres,
        "output_order": "probe_scan",
        "wall_s": round(time.time() - t0, 4),
    }))
    return 0


def main(argv=None) -> int:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")

    p = argparse.ArgumentParser(
        prog="database_technology_algorithms_tpu_torch",
        description="query engine, PyTorch/CUDA port (reference-parity CLI)",
        parents=[common],
    )
    sub = p.add_subparsers(dest="cmd")

    pp = sub.add_parser("pipeline", help="reference main.cpp benchmark flow", parents=[common])
    pp.add_argument("--nblocks", type=int, default=600)
    pp.add_argument("--field", default="1")
    pp.add_argument("--seed", type=int, default=42)
    pp.add_argument("--workdir", default=".")
    pp.add_argument("--skip-files", action="store_true")
    pp.add_argument("--dist", type=int, default=0,
                    help="run on an N-device mesh (not ported yet: nonzero raises)")
    pp.set_defaults(fn=cmd_pipeline)

    mem_help = "bounded-memory mode (not ported yet: nonzero raises)"
    ms = sub.add_parser("mergesort", help="external sort a block file (not ported yet)",
                        parents=[common])
    ms.add_argument("infile")
    ms.add_argument("outfile")
    ms.add_argument("--field", default="1")
    ms.add_argument("--mem-blocks", type=int, default=10000)
    ms.add_argument("--workdir", default=".")
    ms.set_defaults(fn=cmd_mergesort)

    ed = sub.add_parser("elimdup", help="DISTINCT a block file", parents=[common])
    ed.add_argument("infile")
    ed.add_argument("outfile")
    ed.add_argument("--field", default="1")
    ed.add_argument("--mem-blocks", type=int, default=0, help=mem_help)
    ed.add_argument("--workdir", default=".")
    ed.set_defaults(fn=cmd_elimdup)

    for name, fn, text in (
        ("mergejoin", cmd_mergejoin, "sort-merge join two block files"),
        ("hashjoin", cmd_hashjoin, "hash semi-join two block files"),
    ):
        jp = sub.add_parser(name, help=text, parents=[common])
        jp.add_argument("infile1")
        jp.add_argument("infile2")
        jp.add_argument("outfile")
        jp.add_argument("--field", default="1")
        jp.add_argument("--mem-blocks", type=int, default=0, help=mem_help)
        jp.add_argument("--workdir", default=".",
                        help="spill directory of the bounded-memory mode")
        jp.set_defaults(fn=fn)

    # a bare invocation (no subcommand word anywhere) runs the pipeline with
    # pipeline's own flags, mirroring the reference's ./dbt program
    argv = sys.argv[1:] if argv is None else list(argv)
    if not any(a in sub.choices for a in argv):
        return cmd_pipeline(pp.parse_args(argv))
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
