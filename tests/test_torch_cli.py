"""The PyTorch port's CLI against the JAX package's CLI on the same files.

Each command runs in both packages (the port with ``--device cpu``, JAX on
the CPU by conftest) and must print the same JSON counters and write the
same bytes.  Every value is an integer: exact compare.
"""

import json
import sys

import numpy as np
import pytest

from database_technology_algorithms_tpu.__main__ import main as j_main
from database_technology_algorithms_tpu_torch.__main__ import main as t_main
from database_technology_algorithms_tpu_torch.io.blockfile import (
    read_blockfile_numpy, write_blockfile)
from database_technology_algorithms_tpu_torch.io.generator import (
    generate_columns, generate_pair_files)

NBLOCKS = 20
FIELDS = ["0", "1", "2", "3"]


def last_json(capsys) -> dict:
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line.pop("wall_s", None)
    return line


def run_jax(monkeypatch, capsys, argv) -> tuple[int, dict]:
    monkeypatch.setattr(sys, "argv", ["database_technology_algorithms_tpu", *argv])
    rc = j_main()
    return rc, last_json(capsys)


def run_port(capsys, argv) -> tuple[int, dict]:
    rc = t_main([*argv, "--device", "cpu"])
    return rc, last_json(capsys)


def write_pair(tmp_path, nblocks: int) -> tuple[str, str]:
    """Two tables with repeated keys in every field: num in a small range,
    strings from a small alphabet, file2 a reshuffle of part of file1."""
    g = np.random.default_rng(17)
    n = nblocks * 100
    r = generate_columns(nblocks, seed=3, key_range=n // 4)
    r["strs"][:, 2:5] = 0  # two-letter strings: many repeats
    rows = g.integers(0, n, size=n)
    s = {k: v[rows] for k, v in r.items()}
    s["num"] = np.where(g.random(n) < 0.5, s["num"], s["num"] + np.uint32(n)).astype(np.uint32)
    s["recid"] = (s["recid"] + np.uint32(n // 2)).astype(np.uint32)
    f1, f2 = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    write_blockfile(f1, r)
    write_blockfile(f2, s)
    return f1, f2


@pytest.fixture
def pair_files(tmp_path):
    return write_pair(tmp_path, NBLOCKS)


@pytest.mark.parametrize("field", FIELDS)
def test_pipeline_command_matches_jax(field, tmp_path, monkeypatch, capsys):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    argv = ["pipeline", "--nblocks", str(NBLOCKS), "--field", field, "--seed", "7"]
    jrc, want = run_jax(monkeypatch, capsys, [*argv, "--workdir", str(jdir)])
    trc, got = run_port(capsys, [*argv, "--workdir", str(tdir)])
    assert jrc == trc == 0
    assert got == want and got["joins_agree"] is True
    assert set(got) == {"nblocks", "field", "merge_join_pairs", "hash_join_pairs",
                        "joins_agree", "nunique_r", "nunique_s"}
    for name in ("file.bin", "file2.bin", "outmerge.bin", "outhash.bin"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
    if field == "0":  # both files share recids
        assert got["merge_join_pairs"] == NBLOCKS * 100
    if field == "2":  # the planted "Hola" is in both files
        assert got["merge_join_pairs"] >= 1
        out = read_blockfile_numpy(str(tdir / "outmerge.bin"))
        assert any(bytes(row[:5]) == b"Hola\0" for row in out["strs"])


def test_bare_invocation_runs_the_pipeline(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the default --workdir
    argv = ["--nblocks", "3", "--field", "1", "--skip-files"]
    rc, got = run_port(capsys, argv)
    rc2, want = run_port(capsys, ["pipeline", *argv])
    assert rc == rc2 == 0 and got == want and got["nblocks"] == 3
    assert not list(tmp_path.iterdir())  # --skip-files writes nothing


@pytest.mark.parametrize("field", FIELDS)
def test_elimdup_command_matches_jax(field, pair_files, tmp_path, monkeypatch, capsys):
    f1, _ = pair_files
    jout, tout = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jrc, want = run_jax(monkeypatch, capsys, ["elimdup", f1, jout, "--field", field])
    trc, got = run_port(capsys, ["elimdup", f1, tout, "--field", field])
    assert jrc == trc == 0
    assert got == want and set(got) == {"nunique", "rows"}
    assert 0 < got["nunique"] <= got["rows"] == NBLOCKS * 100
    if field != "0":
        assert got["nunique"] < got["rows"]
    assert open(tout, "rb").read() == open(jout, "rb").read()


@pytest.mark.parametrize("field", FIELDS)
def test_hashjoin_command_matches_jax(field, pair_files, tmp_path, monkeypatch, capsys):
    f1, f2 = pair_files
    jout, tout = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jrc, want = run_jax(monkeypatch, capsys, ["hashjoin", f1, f2, jout, "--field", field])
    trc, got = run_port(capsys, ["hashjoin", f1, f2, tout, "--field", field])
    assert jrc == trc == 0
    assert got == want and got["output_order"] == "probe_scan" and got["nres"] > 0
    # the same rows in the same (probe scan) order
    assert open(tout, "rb").read() == open(jout, "rb").read()
    back = read_blockfile_numpy(tout)
    assert len(back["recid"]) == got["nres"]
    if field == "3":  # build duplicates repeat probe rows: more rows out than probe rows hit
        probe = read_blockfile_numpy(f2)
        assert got["nres"] > len(np.unique(back["recid"]))
        assert got["nres"] != len(probe["recid"])


@pytest.mark.parametrize("field", ["2", "3"])
def test_mergejoin_command_matches_jax_on_string_fields(field, pair_files, tmp_path,
                                                        monkeypatch, capsys):
    f1, f2 = pair_files
    jout, tout = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jrc, want = run_jax(monkeypatch, capsys, ["mergejoin", f1, f2, jout, "--field", field])
    trc, got = run_port(capsys, ["mergejoin", f1, f2, tout, "--field", field])
    assert jrc == trc == 0
    assert got == want and got["nres"] > 0
    assert open(tout, "rb").read() == open(jout, "rb").read()


EXTERNAL_KEYS = {
    "mergesort": {"nsorted_segs", "npasses", "rows", "bytes_host"},
    "elimdup": {"nunique", "rows", "external", "mem_rows", "nsorted_segs", "npasses",
                "peak_range_rows"},
    "mergejoin": {"nres", "nunique_r", "nunique_s", "external", "mem_rows", "peak_range_rows",
                  "nsorted_segs"},
    "hashjoin": {"nres", "external", "mem_rows", "peak_range_rows", "nsorted_segs",
                 "output_order"},
}


def external_both(cmd: str, files: list, flags: list, tmp_path, monkeypatch, capsys) -> dict:
    """One command of the external route in both CLIs, each with its own
    work directory: equal JSON lines (but ``wall_s``), byte-identical output
    files, and spill directories left without a file.  Returns the line."""
    lines, outs = {}, {}
    for name, run in (("jax", lambda a: run_jax(monkeypatch, capsys, a)),
                      ("port", lambda a: run_port(capsys, a))):
        work = tmp_path / f"work_{name}"
        work.mkdir(parents=True)
        outs[name] = work / "out.bin"
        rc, lines[name] = run([cmd, *files, str(outs[name]), *flags, "--workdir", str(work)])
        assert rc == 0
        assert [p for p in work.rglob("*") if p.is_file()] == [outs[name]]
    assert lines["port"] == lines["jax"] and set(lines["port"]) == EXTERNAL_KEYS[cmd]
    assert outs["port"].read_bytes() == outs["jax"].read_bytes()
    return lines["port"]


def test_unported_flags_and_commands_raise(pair_files, tmp_path, monkeypatch, capsys):
    """No flag or command is refused any more: the multi-process flags of
    ``pipeline`` parse and run in one process (a gloo group of one, four
    shards; the stage checkpoints, a death after a stage and the resume),
    with the counters of ``--dist 4``; ``mergesort`` and ``--mem-blocks``
    run the external route and equal the JAX CLI; ``--platform`` and a
    field past 3 are refused."""
    import socket

    f1, f2 = pair_files
    out = str(tmp_path / "o.bin")
    cpu = ["--device", "cpu"]
    base = ["pipeline", "--nblocks", "3", "--skip-files", *cpu]
    assert t_main([*base, "--dist", "4"]) == 0
    want = last_json(capsys)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    group = ["--coordinator", f"localhost:{port}", "--num-processes", "1", "--process-id", "0",
             "--local-devices", "4", "--init-timeout", "30", "--heartbeat-timeout", "30"]
    assert t_main([*base, *group]) == 0
    assert last_json(capsys) == want
    ck = ["--stage-checkpoints", str(tmp_path / "c")]
    with pytest.raises(SystemExit) as died:
        t_main([*base, "--dist", "4", *ck, "--fail-after-stage", "local"])
    assert died.value.code == 17
    assert t_main([*base, "--dist", "4", *ck]) == 0
    assert last_json(capsys) == dict(want, resumed_stages=["local"])
    for cmd, files in (("mergesort", [f1]), ("elimdup", [f1]), ("hashjoin", [f1, f2]),
                       ("mergejoin", [f1, f2])):
        line = external_both(cmd, files, ["--mem-blocks", "10"], tmp_path / cmd, monkeypatch,
                             capsys)
        assert line["nsorted_segs"] >= 2
    with pytest.raises(SystemExit):  # --platform belongs to the JAX CLI
        t_main(["pipeline", "--nblocks", "1", "--platform", "cpu"])
    with pytest.raises(ValueError):
        t_main(["elimdup", f1, out, "--field", "4", *cpu])


def test_commands_refuse_inputs_beyond_the_device_budget(tmp_path, monkeypatch, capsys):
    """Block files beyond the default budget route through the external
    drivers by themselves (``mem_rows`` the budget), in both CLIs alike;
    a file within it takes the in-budget route."""
    from database_technology_algorithms_tpu import config as jconfig
    from database_technology_algorithms_tpu_torch import config

    f1, f2 = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    generate_pair_files(f1, f2, 2)
    monkeypatch.setattr(config, "DEFAULT_CONFIG", config.EngineConfig(mem_rows=300))
    monkeypatch.setattr(jconfig, "DEFAULT_CONFIG", jconfig.EngineConfig(mem_rows=300))
    out = str(tmp_path / "o.bin")
    _, line = run_port(capsys, ["elimdup", f1, out])  # 200 rows fit
    assert "external" not in line
    for cmd in ("hashjoin", "mergejoin"):  # 400 rows do not
        line = external_both(cmd, [f1, f2], [], tmp_path / cmd, monkeypatch, capsys)
        assert line["external"] is True and line["mem_rows"] == 300
        assert 0 < line["peak_range_rows"] <= 300
    assert line["nres"] > 0


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("cmd", ["mergesort", "elimdup", "mergejoin", "hashjoin"])
def test_external_commands_match_jax(cmd, field, tmp_path, monkeypatch, capsys):
    """``mergesort``, and the other file commands under ``--mem-blocks``, at
    each key field on 600-row files under a 400-row budget (several
    segments a side)."""
    f1, f2 = write_pair(tmp_path, 6)
    files = [f1] if cmd in ("mergesort", "elimdup") else [f1, f2]
    line = external_both(cmd, files, ["--mem-blocks", "4", "--field", field], tmp_path,
                         monkeypatch, capsys)
    back = read_blockfile_numpy(str(tmp_path / "work_port" / "out.bin"))
    assert line["nsorted_segs"] >= 2
    if cmd == "mergesort":
        assert line["rows"] == len(back["recid"]) == 600 and line["npasses"] == 2
    elif cmd == "hashjoin":
        assert line["output_order"] == "probe_key" and line["nres"] == len(back["recid"]) > 0
    else:
        assert 0 < len(back["recid"]) == line["nunique" if cmd == "elimdup" else "nres"]


def test_pipeline_command_routes_generated_tables_beyond_the_budget(monkeypatch, capsys):
    """The pipeline command's generated tables reach the library routes: a
    budget below one table gives the counters of the default budget."""
    from database_technology_algorithms_tpu_torch import config
    from database_technology_algorithms_tpu_torch.ops import chunked

    argv = ["pipeline", "--nblocks", "3", "--field", "1", "--skip-files"]
    _, want = run_port(capsys, argv)
    monkeypatch.setattr(config, "DEFAULT_CONFIG", config.EngineConfig(mem_rows=128))
    routed = []
    real = chunked.distinct_chunked
    monkeypatch.setattr(chunked, "distinct_chunked",
                        lambda *a, **k: (routed.append(1), real(*a, **k))[1])
    rc, got = run_port(capsys, argv)
    assert rc == 0 and got == want and got["joins_agree"] and got["merge_join_pairs"] > 0
    assert len(routed) == 2  # both tables went through the chunked distinct


DIST_CASES = [("0", "sorted", 4, []), ("1", "skew", 3, []),
              ("2", "overlap", 4, ["--shuffle-chunks", "2"]), ("3", "sorted", 8, ["--skip-files"]),
              ("1", "overlap", 8, ["--shuffle-chunks", "3"])]


@pytest.mark.parametrize("field,engine,ndev,flags", DIST_CASES)
def test_pipeline_dist_command_matches_jax(field, engine, ndev, flags, tmp_path, monkeypatch,
                                           capsys):
    """``pipeline --dist N`` on the files the command writes (or generated
    tables): the JAX CLI's record, field for field but ``wall_s``, and its
    exit code."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    argv = ["pipeline", "--nblocks", str(NBLOCKS), "--field", field, "--seed", "5", "--dist",
            str(ndev), "--join-engine", engine, *flags]
    jrc, want = run_jax(monkeypatch, capsys, [*argv, "--workdir", str(jdir)])
    trc, got = run_port(capsys, [*argv, "--workdir", str(tdir)])
    assert jrc == trc == 0
    assert got == want and got["joins_agree"] is True and got["overflow"] == 0
    assert set(got) == {"mesh_devices", "field", "merge_join_pairs", "hash_join_pairs",
                        "joins_agree", "nunique_r", "nunique_s", "overflow"}
    if "--skip-files" not in flags:
        for name in ("file.bin", "file2.bin"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name
