"""The PyTorch port's pipeline against the JAX package, bit for bit.

Both packages get the same generated rows (numpy, seeded).  JAX runs on the
CPU under both of its materialization routes — the gather route the port
follows and the TPU's placement-sort route (``_direct_place``) — and both
must equal the port.  Every value is an integer or a bool: exact compare.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu.io.blockfile import read_blockfile as j_read
from database_technology_algorithms_tpu.io.generator import generate_columns
from database_technology_algorithms_tpu.models import pipeline as jpipe
from database_technology_algorithms_tpu_torch.__main__ import main as t_cli
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.io.blockfile import write_blockfile as t_write
from database_technology_algorithms_tpu_torch.models import pipeline as tpipe
from database_technology_algorithms_tpu_torch.utils.checks import MemoryBudgetError

NBLOCKS = 30
ROWS = NBLOCKS * 100
COUNTERS = ("nunique_r", "nunique_s", "merge_nres", "hash_nres", "agg_groups", "join_count")


def make_side(seed, recid_start, kind):
    """One side: the bench's key range (3n/10), or keys over the full u32
    range with repeats; about 5% of rows valid=False either way.  Half the
    rows take a 10-byte string from a pool shared by both sides and tied to
    num, so that the string fields repeat and match too, and rows tie on the
    JAX package's 8-byte sort prefix with different full keys."""
    g = np.random.default_rng(seed)
    cols = generate_columns(NBLOCKS, seed=seed, key_range=3 * ROWS // 10,
                            recid_start=recid_start)
    pool = np.zeros((64, 128), dtype=np.uint8)
    pool[:, :8] = np.frombuffer(b"sameprefSAMEPREF", dtype=np.uint8).reshape(2, 8)[
        np.arange(64) % 2]
    pool[:, 8:10] = np.frombuffer(b"abcdefgh", dtype=np.uint8)[
        np.random.default_rng(98).integers(0, 8, size=(64, 2))]
    pooled = g.random(ROWS) < 0.5
    pick = (cols["num"].astype(np.int64) * 7 + g.integers(0, 2, size=ROWS)) % 64
    cols["strs"][pooled] = pool[pick[pooled]]
    if kind == "full_range":
        # one pool of keys for both sides, so that they share keys
        pool = np.random.default_rng(99).integers(0, 2**32, size=ROWS // 4, dtype=np.uint64)
        pool = pool.astype(np.uint32)
        pool[::3] |= np.uint32(1 << 31)
        cols["num"] = pool[g.integers(0, len(pool), size=ROWS)]
        cols["recid"] = cols["recid"] * np.uint32(2654435761)  # spread over u32
    cols["valid"] = g.random(ROWS) > 0.05
    return cols


def pair(kind):
    # S's recids start half-way through R's, so field 0 matches about half
    return make_side(1, 0, kind), make_side(2, ROWS // 2, kind)


def jax_batch(cols):
    return JBatch.from_numpy(cols["recid"], cols["num"], cols["strs"], cols["valid"],
                             normalize=False)


def port_batch(jb):
    return TBatch.from_jax_arrays(
        *(np.asarray(c) for c in (jb.recid, jb.num, jb.strw, jb.valid)), device="cpu")


def assert_same_batch(got: TBatch, want: JBatch):
    np.testing.assert_array_equal(torch_to_u32(got.recid), np.asarray(want.recid))
    np.testing.assert_array_equal(torch_to_u32(got.num), np.asarray(want.num))
    np.testing.assert_array_equal(torch_to_u32(got.strw), np.asarray(want.strw))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.fixture(scope="module", params=["bench", "full_range"])
def batches(request):
    r_cols, s_cols = pair(request.param)
    jr, js = jax_batch(r_cols), jax_batch(s_cols)
    return jr, js, port_batch(jr), port_batch(js)


@pytest.mark.parametrize("jax_route", ["gather", "sort"])
@pytest.mark.parametrize("field", [0, 1, 2, 3])
def test_staged_pipeline_matches_jax(batches, field, jax_route):
    jr, js, tr, ts = batches
    want = jpipe.make_pipeline_staged(field, JConfig(materialize=jax_route))(jr, js)
    for cfg in (TConfig(), TConfig(packed_u32_sorts=False)):
        got = tpipe.make_pipeline_staged(field, cfg)(tr, ts)
        for k in COUNTERS:
            assert int(got[k]) == int(want[k]), k
        assert 0 < int(got["merge_nres"]) < ROWS  # the inputs make counters informative
        assert_same_batch(got["join_out"], want["join_out"])


@pytest.mark.parametrize("field", [0, 1, 2, 3])
def test_stages_compose_to_run(batches, field):
    _, _, tr, ts = batches
    run = tpipe.make_pipeline_staged(field)
    out = run.stage_a(tr, ts)
    assert int(out["cnt"]) == int(out["merge_nres"]) == int(out["matched"].sum())
    joined = run.materialize(out, tr, ts)
    full = run(tr, ts)["join_out"]
    for a, b in zip((joined.recid, joined.num, joined.strw, joined.valid),
                    (full.recid, full.num, full.strw, full.valid)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("field", [0, 1, 2, 3])
def test_pipeline_single_matches_jax(batches, field):
    jr, js, tr, ts = batches
    want = jpipe.pipeline_single(jr, js, field, JConfig(materialize="gather"))
    got = tpipe.pipeline_single_impl(tr, ts, field)
    for k in COUNTERS:
        assert int(got[k]) == int(want[k]), k
    for k in ("count", "sum", "min", "max"):
        w = np.asarray(want["aggs"][k])
        np.testing.assert_array_equal(got["aggs"][k].numpy().view(w.dtype), w, err_msg=k)
    assert_same_batch(got["join_out"], want["join_out"])


def test_aggregate_sum_wraps_mod_2_32():
    """Group sums of large u32 nums wrap as the JAX package's do."""
    g = np.random.default_rng(4)
    n = 400
    big = (np.uint32(0xF0000000) + g.integers(0, 1 << 20, size=n).astype(np.uint32))
    r = JBatch.from_numpy(np.arange(n, dtype=np.uint32), big)
    s = JBatch.from_numpy(np.arange(n, dtype=np.uint32) % 9, big)
    want = jpipe.pipeline_single(r, s, 0)
    got = tpipe.pipeline_single_impl(port_batch(r), port_batch(s), 0)
    w = np.asarray(want["aggs"]["sum"])
    np.testing.assert_array_equal(got["aggs"]["sum"].numpy().view(np.uint32), w)
    # 9 groups of ~44 rows near 2^32 each: every group's true sum exceeds 2^32
    true = np.array([big[np.arange(n) % 9 == k].astype(np.uint64).sum() for k in range(9)])
    assert int(want["agg_groups"]) == 9 and (true > 2**32).all()
    np.testing.assert_array_equal(w[:9], (true % 2**32).astype(np.uint32))


def test_unported_routes_raise():
    with pytest.raises(ValueError):
        tpipe.make_pipeline_staged(4)
    for route in ("sort", "sort2d"):
        for field in (1, "numstr"):
            with pytest.raises(NotImplementedError):
                tpipe.make_pipeline_staged(field, TConfig(materialize=route))
    with pytest.raises(ValueError):
        tpipe.make_pipeline_staged(1, TConfig(materialize="scatter"))
    r = TBatch.from_numpy(np.arange(10, dtype=np.uint32), np.arange(10, dtype=np.uint32),
                          device="cpu")
    # one row over the budget: the runner routes, its in-budget stage and the
    # fused single program still refuse
    over = tpipe.make_pipeline_staged(1, TConfig(mem_rows=19))
    assert int(over(r, r)["merge_nres"]) == 10
    with pytest.raises(MemoryBudgetError, match="ROADMAP"):
        over.stage_a(r, r)
    with pytest.raises(MemoryBudgetError):
        tpipe.pipeline_single_impl(r, r, 1, TConfig(mem_rows=19))
    assert int(tpipe.make_pipeline_staged(1, TConfig(mem_rows=20))(r, r)["merge_nres"]) == 10


def test_mergejoin_cli_on_cpu(tmp_path, capsys):
    r_cols, s_cols = pair("bench")
    f1, f2, out = (str(tmp_path / n) for n in ("file1.bin", "file2.bin", "outmerge.bin"))
    t_write(f1, r_cols)
    t_write(f2, s_cols)
    assert t_cli(["mergejoin", f1, f2, out, "--field", "1", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jr, js = j_read(f1, prefer_native=False), j_read(f2, prefer_native=False)
    want = jpipe.make_pipeline_staged(1, JConfig(materialize="gather"))(jr, js)
    nres = int(want["merge_nres"])
    assert line["nres"] == nres
    assert line["nunique_r"] == int(want["nunique_r"])
    back = j_read(out, prefer_native=False)
    assert back.nrows == nres
    for c in ("recid", "num", "strw", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(back, c)), np.asarray(getattr(want["join_out"], c))[:nres])
    assert jnp.all(back.valid)  # matched rows are active rows
