"""The port's distributed plan, ``models/pipeline.make_dist_pipeline``,
against the JAX package's, bit for bit.

Fields 0-3 under the three HashJoin cross-check engines (``sorted``,
``skew``, ``overlap``) with one exchange slice (two, and the Zipf pair, in
``test_torch_dist_pipeline_chunks.py``), over meshes of 8, 4 and 3 shards
(taken in turn), on tables with invalid rows, keys on both sides of 2^31 and
strings of 2 stored words (where the overlap engine takes string keys) or 4
(where it falls back); the 2 x 4 host-chip mesh.  Every output is compared:
the replicated counters, each shard's ``join_out`` block, ``join_counts``,
``agg_count`` and ``agg_sum``, and ``overflow``; the counters also against
the port's single-device ``pipeline_single_impl``.  JAX runs on its forced
CPU devices, the port on CPU shards (the kernels' plain versions); inputs
come from numpy with a seed.
"""

import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.io.generator import generate_columns
from database_technology_algorithms_tpu_torch.models import pipeline as tpipe
from database_technology_algorithms_tpu_torch.parallel import dist_ops as tdist
from test_torch_operators import assert_same_batch, both_batches, make_cols
from test_torch_parallel import meshes

jdist = importlib.import_module("database_technology_algorithms_tpu.parallel.dist_ops")
jpipe = importlib.import_module("database_technology_algorithms_tpu.models.pipeline")

ENGINES = ["sorted", "skew", "overlap"]
COUNTERS = ("nunique_r", "nunique_s", "merge_nres", "hash_nres", "agg_groups")


@functools.lru_cache(maxsize=None)
def pair(kind, case: str):
    ndev = 8 if kind == "2x4" else kind
    if case == "zipf":
        r = generate_columns(3 * ndev, seed=5, zipf_a=1.2, key_range=600)
        s = generate_columns(3 * ndev, seed=6, zipf_a=1.2, key_range=600)
        r["valid"] = np.random.default_rng(1).random(len(r["valid"])) > 0.1
        return r, s
    strings = "short" if case == "short" else "tie"
    return (make_cols(260 * ndev - 13, seed=7, strings=strings),
            make_cols(240 * ndev - 5, seed=8, strings=strings))


@functools.lru_cache(maxsize=None)
def jax_run(kind, field, engine: str, nchunks: int, case: str):
    jm, _ = meshes(kind)
    r, s = pair(kind, case)
    t1, t2 = jdist.distribute(jm, r), jdist.distribute(jm, s)
    cfg = JConfig(shuffle_slack=4.0, dist_join_engine=engine, shuffle_nchunks=nchunks)
    out = jpipe.make_dist_pipeline(jm, field, cfg)(t1.batch, t1.count, t2.batch, t2.count)
    return jax.tree_util.tree_map(np.asarray, dict(out))


def run_both(kind, field, engine, nchunks, case):
    want = jax_run(kind, field, engine, nchunks, case)
    _, tm = meshes(kind)
    r, s = pair(kind, case)
    t1, t2 = tdist.distribute(tm, r), tdist.distribute(tm, s)
    cfg = TConfig(shuffle_slack=4.0, dist_join_engine=engine, shuffle_nchunks=nchunks)
    got = tpipe.make_dist_pipeline(tm, field, cfg)(t1.batches, t1.counts, t2.batches, t2.counts)
    return r, s, got, want


def same_run(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in COUNTERS + ("overflow",):
        assert int(got[k]) == int(want[k]), k
    assert_same_batch(TBatch.concat(got["join_out"]), want["join_out"])
    np.testing.assert_array_equal(torch.stack(got["join_counts"]).numpy(), want["join_counts"])
    for k in ("agg_count", "agg_sum"):
        np.testing.assert_array_equal(torch_to_u32(torch.cat(got[k])),
                                      want[k].astype(np.uint32))


def single_counters(r: dict, s: dict, field) -> dict:
    _, tr = both_batches(r)
    _, ts = both_batches(s)
    out = tpipe.pipeline_single_impl(tr, ts, field, TConfig())
    return {k: int(out[k]) for k in COUNTERS}


def cases(nchunks: int) -> list:
    """(mesh, field, engine, nchunks): fields 0-3 by the three engines, the
    meshes of 8, 4 and 3 shards in turn."""
    return [([8, 4, 3][(i + i // 3 + nchunks) % 3], f, e, nchunks)
            for i, (f, e) in enumerate((f, e) for f in (0, 1, 2, 3) for e in ENGINES)]


def check_case(kind, field, engine, nchunks) -> None:
    case = "short" if field in (2, 3) and nchunks == 1 else "tie"
    r, s, got, want = run_both(kind, field, engine, nchunks, case)
    same_run(got, want)
    assert int(got["overflow"]) == 0 and int(got["merge_nres"]) > 0
    assert {k: int(got[k]) for k in COUNTERS} == single_counters(r, s, field)
    assert int(got["merge_nres"]) == int(got["hash_nres"])


@pytest.mark.parametrize("kind,field,engine,nchunks", cases(1))
def test_dist_pipeline_matches_jax(kind, field, engine, nchunks):
    """One exchange slice (the chunked exchange: test_torch_dist_pipeline_chunks.py)."""
    check_case(kind, field, engine, nchunks)


@pytest.mark.parametrize("field,engine", [(1, "sorted"), (2, "skew"), (3, "overlap"),
                                          (0, "overlap")])
def test_dist_pipeline_host_chip_mesh_matches_jax(field, engine):
    r, s, got, want = run_both("2x4", field, engine, 2, "short")
    same_run(got, want)
    assert {k: int(got[k]) for k in COUNTERS} == single_counters(r, s, field)


def test_dist_pipeline_stages_compose():
    """The step is its three stage functions in turn (the chip script times
    them one by one)."""
    _, tm = meshes(3)
    r, s = pair(3, "tie")
    t1, t2 = tdist.distribute(tm, r), tdist.distribute(tm, s)
    cfg = TConfig(shuffle_slack=4.0)
    whole = tpipe.make_dist_pipeline(tm, 1, cfg)(t1.batches, t1.counts, t2.batches, t2.counts)
    cap_r, cap_s = tpipe._dist_caps(t1.rows_per_chip, t2.rows_per_chip, 3, cfg)
    local = [tpipe._dist_stage_local(a, b, c, d, 1, cfg)
             for a, b, c, d in zip(t1.batches, t1.counts, t2.batches, t2.counts)]
    shuffled = tpipe._dist_stage_shuffle(tm, *(list(x) for x in zip(*local)), 1, cfg, cap_r,
                                         cap_s)
    parts = tpipe._dist_stage_join(tm, *shuffled[:5], 1, cfg, cap_r, cap_s)
    for k in COUNTERS:
        assert int(parts[k]) == int(whole[k])
    assert int(parts["overflow"]) + int(shuffled[5][0]) == int(whole["overflow"])
