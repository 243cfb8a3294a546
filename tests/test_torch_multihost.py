"""The port's multi-process runtime in real separate processes on the CPU.

Each test launches port processes of four local shards each against a
localhost coordinator (gloo collectives), as ``tests/test_multihost.py``
launches the JAX package's, through the CLI's ``--coordinator``,
``--num-processes`` and ``--process-id``: both processes print the same
counters, equal to JAX's ``pipeline_single`` and to the port's
single-process ``--dist 8``; a missing peer fails the rendezvous within
its timeout; a peer killed mid-run makes the survivor fail within the
heartbeat bound, and a re-run succeeds; a stage checkpoint survives an
injected death and a re-run resumes from it.  The process-group backend's
three collectives are held against the in-process mesh's copies by this
file run as a script in two processes, and a checkpoint's cleanup leaves
another process's files.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "database_technology_algorithms_tpu_torch"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env() -> dict:
    e = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    e.pop("XLA_FLAGS", None)
    return e


def launch(port: int, nproc: int, pid: int, nblocks: int, field: int, extra=()):
    return subprocess.Popen(
        [sys.executable, "-m", PKG, "pipeline", "--nblocks", str(nblocks), "--field",
         str(field), "--skip-files", "--device", "cpu", "--coordinator", f"localhost:{port}",
         "--num-processes", str(nproc), "--process-id", str(pid), "--local-devices", "4",
         *extra],
        env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)


def last_json(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        if line.strip().startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in the output:\n{out}")


def run_pair(nblocks: int, field: int, extra=(), want_rc: int = 0) -> list[dict]:
    port = free_port()
    procs = [launch(port, 2, pid, nblocks, field, extra) for pid in (0, 1)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == want_rc, f"rc={p.returncode}\n{stdout}\n{stderr}"
        outs.append(last_json(stdout) if want_rc == 0 else None)
    return outs


COUNTERS = ("merge_join_pairs", "hash_join_pairs", "nunique_r", "nunique_s")


def single_card(nblocks: int, field: int) -> dict:
    """JAX's pipeline_single on the CLI's tables (seeds 42 and 43)."""
    from database_technology_algorithms_tpu.io.generator import generate_batch
    from database_technology_algorithms_tpu.models.pipeline import pipeline_single

    ref = pipeline_single(generate_batch(nblocks, seed=42), generate_batch(nblocks, seed=43),
                          field)
    return {"merge_join_pairs": int(ref["merge_nres"]), "hash_join_pairs": int(ref["hash_nres"]),
            "nunique_r": int(ref["nunique_r"]), "nunique_s": int(ref["nunique_s"])}


def port_dist8(nblocks: int, field: int, engine: str, capsys) -> dict:
    from database_technology_algorithms_tpu_torch.__main__ import main as t_main

    assert t_main(["pipeline", "--nblocks", str(nblocks), "--field", str(field), "--skip-files",
                   "--device", "cpu", "--dist", "8", "--join-engine", engine]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line.pop("wall_s")
    return line


@pytest.mark.parametrize("field,engine", [(1, "sorted"), (2, "skew"), (0, "overlap")])
def test_two_processes_match_single_card_and_dist8(field, engine, capsys):
    """(a) Two processes of four shards: the same global counters in both,
    equal to JAX's single-card pipeline and to the port's one-process
    ``--dist 8``, under each HashJoin engine (the skew engine's all-gathers
    and the overlapped join's key exchanges cross the processes too)."""
    nblocks = 10
    outs = run_pair(nblocks, field, ("--join-engine", engine))
    for o in outs:
        o.pop("wall_s")
    assert outs[0] == outs[1]
    assert outs[0]["mesh_devices"] == 8 and outs[0]["joins_agree"] and outs[0]["overflow"] == 0
    assert {k: outs[0][k] for k in COUNTERS} == single_card(nblocks, field)
    assert outs[0] == port_dist8(nblocks, field, engine, capsys)


def test_missing_peer_fails_the_rendezvous():
    """(b) Process 1 never joins: process 0's rendezvous fails within its
    12 s timeout, a raised error naming it, not a hang."""
    t0 = time.time()
    p0 = launch(free_port(), 2, 0, 5, 1, ("--init-timeout", "12"))
    stdout, stderr = p0.communicate(timeout=120)
    assert p0.returncode != 0
    assert time.time() - t0 < 60
    assert "timeout" in (stdout + stderr).lower(), stderr[-2000:]


def test_killed_peer_fails_the_survivor_and_a_rerun_succeeds():
    """(c) Process 1 is killed right after its rendezvous marker: process 0
    fails within the heartbeat bound (10 s) with an error, and a re-run of
    both completes with the counters of the single card."""
    port = free_port()
    hb = ("--heartbeat-timeout", "10")
    p0 = launch(port, 2, 0, 8, 1, hb)
    p1 = launch(port, 2, 1, 8, 1, hb)
    joined = False
    for line in p1.stderr:
        if "rendezvous complete" in line:
            joined = True
            break
    assert joined, "process 1 never passed the rendezvous"
    os.kill(p1.pid, signal.SIGKILL)
    p1.wait(timeout=30)
    t0 = time.time()
    stdout, stderr = p0.communicate(timeout=120)
    assert p0.returncode != 0, f"the survivor must fail\n{stdout}\n{stderr}"
    assert time.time() - t0 < 60
    outs = run_pair(8, 1)
    assert outs[0]["joins_agree"] and outs[0]["overflow"] == 0
    assert {k: outs[0][k] for k in COUNTERS} == {k: outs[1][k] for k in COUNTERS} == \
        single_card(8, 1)


def test_stage_checkpoint_death_and_resume(tmp_path):
    """(d) Both processes die (exit 17) right after the "local" stage
    checkpointed; the manifest and both processes' shards survive, and a
    re-run loads the stage (``resumed_stages``) and gives the single card's
    counters."""
    nblocks = 8
    ck = str(tmp_path / "stages")
    run_pair(nblocks, 1, ("--stage-checkpoints", ck, "--fail-after-stage", "local"), want_rc=17)
    for name in ("manifest.json", "local.p0.npz", "local.p1.npz"):
        assert os.path.exists(os.path.join(ck, name)), name
    outs = run_pair(nblocks, 1, ("--stage-checkpoints", ck))
    for o in outs:
        assert o["resumed_stages"] == ["local"], o
        assert o["joins_agree"] and o["overflow"] == 0
        assert {k: o[k] for k in COUNTERS} == single_card(nblocks, 1)
    assert os.listdir(ck) == []  # a completed run removes every process's files


# ---------------------------------------------------------------------------
# (e) the collectives, this file run as a script in each process

LOCAL = 3  # shards a process
ROWS = 2 * LOCAL * 5  # a tensor a shard: 5 rows a destination shard of the 6


def shard_inputs(d: int) -> dict:
    """Global shard d's operands: int32 rows tagged by shard and row, bools,
    and sums that wrap past 2^32."""
    g = np.random.default_rng(d)
    return {"i32": torch.from_numpy((d * 1000 + np.arange(ROWS)).astype(np.int32)),
            "bool": torch.from_numpy(g.random(ROWS) < 0.5),
            "words": torch.from_numpy(g.integers(-2**31, 2**31, size=(ROWS, 2)).astype(np.int32)),
            "wrap": torch.tensor([2**31 - 1 - d, -2**31 + d, 7 * d], dtype=torch.int32)}


def collective_results(mesh, shards) -> dict:
    """The three collectives of `mesh` on the inputs of global `shards`."""
    ins = [shard_inputs(d) for d in shards]
    out = {}
    for name in ("i32", "bool", "words"):
        out[f"all_to_all {name}"] = mesh.all_to_all([x[name] for x in ins])
        out[f"all_gather {name}"] = mesh.all_gather([x[name] for x in ins])
    out["psum"] = mesh.psum([x["wrap"] for x in ins])
    out["psum i32"] = mesh.psum([x["i32"] for x in ins])
    return out


def collectives_main(pid: int, port: int) -> int:
    """A process of two: its shards' results over the gloo group against
    the in-process mesh of all six shards."""
    from database_technology_algorithms_tpu_torch.parallel.mesh import make_mesh
    from database_technology_algorithms_tpu_torch.parallel.multihost import initialize, shutdown

    mesh = initialize(f"localhost:{port}", 2, pid, local_devices=LOCAL, device="cpu",
                      initialization_timeout=60, heartbeat_timeout=60)
    assert mesh.size == 2 * LOCAL and list(mesh.local_shards) == [pid * LOCAL + j
                                                                  for j in range(LOCAL)]
    got = collective_results(mesh, mesh.local_shards)
    want = collective_results(make_mesh(2 * LOCAL, devices="cpu"), range(2 * LOCAL))
    for name, parts in got.items():
        assert len(parts) == LOCAL, name
        for j, d in enumerate(mesh.local_shards):
            assert parts[j].dtype == want[name][d].dtype, name
            assert torch.equal(parts[j], want[name][d]), f"{name}, shard {d}"
    total = sum(2**31 - 1 - d for d in range(2 * LOCAL))
    assert int(got["psum"][0][0]) == (total + 2**31) % 2**32 - 2**31 != total  # wrapped
    shutdown()
    print(f"collectives ok {pid}", flush=True)
    return 0


def test_group_collectives_match_the_in_process_mesh():
    """(e) all_to_all, all_gather and psum over a two-process gloo group, on
    int32, bool and two-word int32 tensors, equal the in-process mesh's
    copies shard for shard; a psum of int32 words wraps past 2^32."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(port)],
                              env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO) for pid in (0, 1)]
    for pid, p in enumerate(procs):
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, f"rc={p.returncode}\n{stdout}\n{stderr}"
        assert f"collectives ok {pid}" in stdout


def test_cleanup_leaves_another_process_files(tmp_path):
    """(f) A process's cleanup removes its own ``*.p{pid}.*`` files (process 0
    also the manifest) and never another process's, even one whose id
    starts with the same digit."""
    from database_technology_algorithms_tpu_torch.parallel.checkpoint import StageCheckpoints
    from database_technology_algorithms_tpu_torch.parallel.mesh import Mesh

    cpu = torch.device("cpu")
    names = ["manifest.json"] + [f"{stage}.p{pid}.{ext}" for stage in ("local", "shuffle")
                                 for pid in (0, 1, 10) for ext in ("npz", "meta.json")]
    for name in names:
        (tmp_path / name).write_text("x")

    def ckpt(pid):
        mesh = Mesh((cpu, cpu), process_index=pid, process_count=11, group=object())
        return StageCheckpoints(str(tmp_path), mesh)

    ckpt(1).cleanup()
    assert sorted(os.listdir(tmp_path)) == sorted(n for n in names if ".p1." not in n)
    ckpt(0).cleanup()
    assert sorted(os.listdir(tmp_path)) == sorted(n for n in names if ".p10." in n)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    raise SystemExit(collectives_main(int(sys.argv[1]), int(sys.argv[2])))
