"""Command line of the PyTorch port — the heir of the reference's benchmark
program (``main.cpp:20-136``), with the JAX package's subcommands:

    pipeline   generate two tables, MergeJoin + HashJoin, cross-check counts
               (the reference main.cpp flow; also what a bare invocation runs)
    elimdup    DISTINCT a block file
    mergejoin  sort-merge join two block files (distinct-key intersection)
    hashjoin   hash semi-join two block files (probe-side rows)
    mergesort  external sort of a block file (bounded memory, spill segments)

    python -m database_technology_algorithms_tpu_torch --nblocks 10000 --field 1 --skip-files
    python -m database_technology_algorithms_tpu_torch mergejoin f1.bin f2.bin out.bin --field 1

All commands read and write the reference's binary block format, print a
stats JSON line, and run on the card unless ``--device cpu`` is given.
The ``pipeline`` command's generated tables take the library routes at any
size: beyond the device budget (``EngineConfig.mem_rows``) ``distinct`` goes
through the chunked passes and ``hash_join`` through the tiled join.  The
file commands take the external route (``external.py``: spill segments in
``--workdir``, at most ``mem_rows`` rows on the card at a time) under
``--mem-blocks``, and by themselves for block files beyond the default
budget.  ``pipeline --dist N`` runs the distributed plan
(``models/pipeline.make_dist_pipeline``) over N shards in this process, shard
d on card ``d % device_count`` (or all on the CPU with ``--device cpu``).
With ``--coordinator host:port --num-processes P --process-id p
--local-devices L`` it runs as process p of P, each of L shards on its one
card over NCCL (or on the CPU over gloo with ``--device cpu``), after a
rendezvous that fails past ``--init-timeout`` seconds; a dead peer fails the
others' collectives within ``--heartbeat-timeout`` (shown over gloo; over
NCCL the bound rests on torch's asynchronous error handling).  ``--stage-checkpoints
DIR`` runs the plan stage by stage, each stage's shards saved to DIR, and a
re-run resumes past the stages done (``--fail-after-stage`` injects a death,
exit 17, after one).
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


def _external_budget(args, *paths) -> int | None:
    """The row budget of the external route, or None for the in-budget one:
    an explicit ``--mem-blocks`` wins; otherwise inputs beyond the default
    device budget route through the external drivers by themselves."""
    from . import config

    if args.mem_blocks:
        return args.mem_blocks * 100
    if sum(_blockfile_rows(p) for p in paths) > config.DEFAULT_CONFIG.mem_rows:
        return config.DEFAULT_CONFIG.mem_rows
    return None


def _write_chunks(path: str, chunks) -> None:
    """Stream an external driver's output chunks into a block file."""
    from .io.blockfile import BlockFileWriter

    with BlockFileWriter(path) as w:
        for chunk in chunks:
            w.append(chunk)


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

    mesh = None
    if args.coordinator:
        # the multi-process entry: the rendezvous first, then the same plan
        # over the global mesh
        from .parallel.multihost import initialize

        if not args.skip_files:
            print("ERROR: multi-process runs require --skip-files")
            return 1
        mesh = initialize(args.coordinator, args.num_processes, args.process_id,
                          local_devices=args.local_devices, device=args.device,
                          initialization_timeout=args.init_timeout,
                          heartbeat_timeout=args.heartbeat_timeout)
    device = mesh.devices[0] if mesh is not None else resolve_device(args.device)
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
    if args.debug_checks:
        from .utils.checks import assert_batch

        assert_batch(r)
        assert_batch(s)
    print(f"[gen] done in {time.time() - t0:.2f}s on {device.type}")
    if args.dist or mesh is not None:
        from .parallel.multihost import shutdown

        try:
            rc = _pipeline_dist(args, r, s, field, device, mesh)
        except SystemExit:  # the injected death after a stage: leave the group first
            shutdown()
            raise
        shutdown()
        return rc

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


def _pipeline_dist(args, r, s, field: int, device, mesh=None) -> int:
    """``pipeline --dist N``: the distributed plan over N shards (or, with a
    process group's `mesh`, over all of its processes' shards), the JAX
    CLI's JSON record and exit code (1 unless the joins agree with no
    overflow)."""
    import torch

    from .config import EngineConfig
    from .models.pipeline import make_dist_pipeline_staged
    from .parallel.mesh import make_mesh
    from .parallel.dist_ops import distribute

    n = args.dist or mesh.size
    if mesh is not None and n != mesh.size:
        print("ERROR: multi-process runs use all global devices (--dist must match)")
        return 1
    if mesh is None and device.type == "cuda":
        count = torch.cuda.device_count()
        mesh = make_mesh(devices=[torch.device("cuda", d % count) for d in range(n)])
    elif mesh is None:
        mesh = make_mesh(n, devices=device)
    cfg = EngineConfig(shuffle_slack=4.0, dist_join_engine=args.join_engine,
                       shuffle_nchunks=args.shuffle_chunks)
    step = make_dist_pipeline_staged(mesh, field, cfg, ckpt_dir=args.stage_checkpoints,
                                     fail_after=args.fail_after_stage)
    t1, t2 = distribute(mesh, r.to_numpy()), distribute(mesh, s.to_numpy())
    t0 = time.time()
    out = step(t1.batches, t1.counts, t2.batches, t2.counts)
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = time.time() - t0
    merge, hashed = int(out["merge_nres"]), int(out["hash_nres"])
    rec = {
        "mesh_devices": n,
        "field": field,
        "merge_join_pairs": merge,
        "hash_join_pairs": hashed,
        "joins_agree": merge == hashed,
        "nunique_r": int(out["nunique_r"]),
        "nunique_s": int(out["nunique_s"]),
        "overflow": int(out["overflow"]),
        "wall_s": round(dt, 4),
    }
    if "resumed_stages" in out:
        rec["resumed_stages"] = out["resumed_stages"]
    print(json.dumps(rec))
    return 0 if rec["joins_agree"] and rec["overflow"] == 0 else 1


def cmd_mergesort(args) -> int:
    from .batch import canonical_field
    from .external import blockfile_chunks, external_sort
    from .metrics import OperatorStats
    from .utils.checks import resolve_device

    device = resolve_device(args.device)
    field = canonical_field(args.field)
    stats = OperatorStats(op="mergesort")
    mem_rows = args.mem_blocks * 100
    spill = os.path.join(args.workdir, "spill")
    _write_chunks(args.outfile, external_sort(
        blockfile_chunks(args.infile, mem_rows), field, spill,
        mem_rows=mem_rows, stats=stats, device=device,
    ))
    print(json.dumps({
        "nsorted_segs": stats.nsorted_segs,
        "npasses": stats.npasses,
        "rows": stats.rows_in,
        "bytes_host": stats.bytes_host,
        "wall_s": round(stats.wall_s, 4),
    }))
    return 0


def cmd_elimdup(args) -> int:
    from .batch import canonical_field
    from .io.blockfile import read_blockfile, write_blockfile
    from .ops.distinct import distinct
    from .ops.filter import truncate
    from .utils.checks import resolve_device

    device = resolve_device(args.device)
    field = canonical_field(args.field)
    mem_rows = _external_budget(args, args.infile)
    if mem_rows is not None:
        # bounded-memory DISTINCT: the external sort's distinct form
        # (EliminateDuplicates is MergeSort + adjacent dedup in the
        # reference, DatabaseProject.cpp:94-170)
        from .external import blockfile_chunks, external_sort
        from .metrics import OperatorStats

        stats = OperatorStats(op="external_distinct")
        t0 = time.time()
        _write_chunks(args.outfile, external_sort(
            blockfile_chunks(args.infile, mem_rows), field,
            os.path.join(args.workdir, "spill_ed"),
            mem_rows=mem_rows, stats=stats, distinct=True, device=device,
        ))
        print(json.dumps({
            "nunique": stats.rows_out,
            "rows": stats.rows_in,
            "external": True,
            "mem_rows": mem_rows,
            "nsorted_segs": stats.nsorted_segs,
            "npasses": stats.npasses,
            "peak_range_rows": stats.peak_range_rows,
            "wall_s": round(time.time() - t0, 4),
        }))
        return 0
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
    mem_rows = _external_budget(args, args.infile1, args.infile2)
    if mem_rows is not None:
        from .external import blockfile_chunks, external_merge_join
        from .metrics import OperatorStats

        stats = OperatorStats(op="external_merge_join")
        t0 = time.time()
        _write_chunks(args.outfile, external_merge_join(
            blockfile_chunks(args.infile1, max(mem_rows // 2, 1)),
            blockfile_chunks(args.infile2, max(mem_rows // 2, 1)),
            field, os.path.join(args.workdir, "spill_mj"),
            mem_rows=mem_rows, stats=stats, device=device,
        ))
        print(json.dumps({
            "nres": stats.nres,
            "nunique_r": stats.nunique_r,
            "nunique_s": stats.nunique_s,
            "external": True,
            "mem_rows": mem_rows,
            "peak_range_rows": stats.peak_range_rows,
            "nsorted_segs": stats.nsorted_segs,
            "wall_s": round(time.time() - t0, 4),
        }))
        return 0
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
    """Hash semi-join two block files (probe rows out).

    The in-budget route emits matched probe rows in probe SCAN order (like
    the reference's probe loop, ``DatabaseProject.cpp:583-629``); the
    external route (``--mem-blocks``, or inputs beyond the budget) streams
    them in probe KEY order.  The rows and ``nres`` are the same; the JSON
    line says which order the file has."""
    from .batch import canonical_field
    from .io.blockfile import read_blockfile, write_blockfile
    from .ops.filter import truncate
    from .ops.hash_join import hash_join, hash_join_count, materialize_field3
    from .utils.checks import resolve_device

    device = resolve_device(args.device)
    field = canonical_field(args.field)
    mem_rows = _external_budget(args, args.infile1, args.infile2)
    if mem_rows is not None:
        from .external import blockfile_chunks, external_hash_join
        from .metrics import OperatorStats

        stats = OperatorStats(op="external_hash_join")
        t0 = time.time()
        _write_chunks(args.outfile, external_hash_join(
            blockfile_chunks(args.infile1, max(mem_rows // 2, 1)),
            blockfile_chunks(args.infile2, max(mem_rows // 2, 1)),
            field, os.path.join(args.workdir, "spill_hj"),
            mem_rows=mem_rows, stats=stats, device=device,
        ))
        print(json.dumps({
            "nres": stats.nres,
            "external": True,
            "mem_rows": mem_rows,
            "peak_range_rows": stats.peak_range_rows,
            "nsorted_segs": stats.nsorted_segs,
            "output_order": "probe_key",
            "wall_s": round(time.time() - t0, 4),
        }))
        return 0
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
                    help="run the distributed plan on an N-shard mesh (shard d on card "
                         "d %% device_count, or all on the CPU with --device cpu)")
    pp.add_argument("--join-engine", default="sorted", dest="join_engine",
                    choices=["sorted", "skew", "overlap"],
                    help="HashJoin cross-check engine in the dist plan "
                         "(skew = heavy-hitter machinery, overlap = "
                         "key-only chunked exchange; u32 fields)")
    pp.add_argument("--shuffle-chunks", type=int, default=1, dest="shuffle_chunks",
                    help=">1 splits the exchanges into that many slices")
    pp.add_argument("--coordinator", default=None,
                    help="multi-process: coordinator address host:port (process 0 listens)")
    pp.add_argument("--num-processes", type=int, default=1)
    pp.add_argument("--process-id", type=int, default=0)
    pp.add_argument("--local-devices", type=int, default=None,
                    help="shards of this process, all on its one device (default 1)")
    pp.add_argument("--init-timeout", type=int, default=300, dest="init_timeout",
                    help="multi-process rendezvous timeout (failure detection)")
    pp.add_argument("--heartbeat-timeout", type=int, default=100, dest="heartbeat_timeout",
                    help="multi-process liveness: seconds a collective waits for a peer "
                         "before it fails (failure detection)")
    pp.add_argument("--debug-checks", action="store_true",
                    help="validate batch invariants at ingestion (utils/checks)")
    pp.add_argument("--stage-checkpoints", default=None, dest="stage_checkpoints",
                    help="dist runs: save each stage's shards to this directory "
                         "(manifest-resumable; a re-run skips the stages done)")
    pp.add_argument("--fail-after-stage", default=None, dest="fail_after_stage",
                    choices=["local", "shuffle"],
                    help="fault injection: exit 17 right after the named stage checkpoints")
    pp.set_defaults(fn=cmd_pipeline)

    ms = sub.add_parser("mergesort", help="external sort a block file", parents=[common])
    ms.add_argument("infile")
    ms.add_argument("outfile")
    ms.add_argument("--field", default="1")
    ms.add_argument("--mem-blocks", type=int, default=10000,
                    help="memory budget in 100-row blocks (nmem_blocks heir)")
    ms.add_argument("--workdir", default=".")
    ms.set_defaults(fn=cmd_mergesort)

    ed = sub.add_parser("elimdup", help="DISTINCT a block file", parents=[common])
    ed.add_argument("infile")
    ed.add_argument("outfile")
    ed.add_argument("--field", default="1")
    ed.add_argument("--mem-blocks", type=int, default=0,
                    help="bounded-memory mode: device budget in 100-row "
                         "blocks (0 = auto: external only when the input "
                         "exceeds the default device budget)")
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
        jp.add_argument("--mem-blocks", type=int, default=0,
                        help="bounded-memory mode: device budget in 100-row "
                             "blocks (0 = auto: external only when the inputs "
                             "exceed the default device budget)")
        jp.add_argument("--workdir", default=".")
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
