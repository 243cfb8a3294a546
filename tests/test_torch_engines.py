"""The alternative u32 engines, ``cfg.u32_join_engine`` and
``cfg.u32_distinct_engine``, against the JAX package, bit for bit.

The JAX package leaves its generic path only for key fields 0 and 1 (the
join: ``ops/hash_join.py:516``; distinct: ``"fastpath"`` with no ``active``
mask, ``ops/distinct.py:100-104``), and the port dispatches exactly there:
"searchsorted" (``ops/fastpath.py``), "table" (``ops/hash_table.py``) and
"bucketed" (``ops/bucket_join.py``, whose fallback is ``build_key_multiset``
+ ``probe_multiplicity``), and ``distinct_u32``.  Everywhere else both
packages run the generic path.  Inputs are made from a seed with numpy, JAX
runs on the CPU and the port on CPU tensors (the kernels' plain versions);
every result is an integer or a bool and must be equal (tolerance 0).

One input is where the two differ by design: the JAX package's table
stores the key whose mix is 0xFFFFFFFF as 0xFFFFFFFE, the mix of another
key, and then finds that other key in a set that lacks it.  The port equals
the generic engine there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model as M

from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu_torch import external as text
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.ops import distinct as tdistinct
from database_technology_algorithms_tpu_torch.ops import hash_join as thash
from database_technology_algorithms_tpu_torch.ops import hash_table as ttable
from database_technology_algorithms_tpu_torch.ops import merge_join as tmerge
from test_torch_engines_schedule import inverse_mix
from test_torch_operators import assert_same_batch, both_batches, make_cols

JOPS = "database_technology_algorithms_tpu.ops."
jdistinct = importlib.import_module(JOPS + "distinct")
jhash = importlib.import_module(JOPS + "hash_join")
jmerge = importlib.import_module(JOPS + "merge_join")

JOIN_ENGINES = ["searchsorted", "table", "bucketed"]


def tables(n: int, seed: int):
    """A build table and a probe table of about n rows that share keys."""
    jb, tb = both_batches(make_cols(n, seed=seed))
    jp, tp = both_batches(make_cols(n * 3 // 2, seed=seed + 1))
    return jb, tb, jp, tp


@pytest.mark.parametrize("engine", JOIN_ENGINES)
@pytest.mark.parametrize("field", [2, 3])
def test_hash_join_count_other_fields_run_generic(field, engine):
    jb, tb, jp, tp = tables(300, seed=400 + field)
    wm, wmult, wn = jhash.hash_join_count(jb, jp, field, JConfig(u32_join_engine=engine))
    gm, gmult, gn = thash.hash_join_count(tb, tp, field, TConfig(u32_join_engine=engine))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gmult.numpy(), np.asarray(wmult))
    assert int(gn) == int(wn) > 0


@pytest.mark.parametrize("engine", JOIN_ENGINES)
@pytest.mark.parametrize("field", [2, 3])
def test_hash_join_other_fields_run_generic(field, engine):
    jb, tb, jp, tp = tables(300, seed=410 + field)
    want, wn = jhash.hash_join(jb, jp, field, JConfig(u32_join_engine=engine))
    got, gn = thash.hash_join(tb, tp, field, TConfig(u32_join_engine=engine))
    assert int(gn) == int(wn) > 0
    assert_same_batch(got, want)


@pytest.mark.parametrize("field", [2, 3])
def test_distinct_fastpath_other_fields_run_generic(field):
    jb, tb = both_batches(make_cols(300, seed=420 + field))
    want, wn = jdistinct.distinct(jb, field, JConfig(u32_distinct_engine="fastpath"))
    got, gn = tdistinct.distinct(tb, field, TConfig(u32_distinct_engine="fastpath"))
    assert int(gn) == int(wn) > 0
    assert_same_batch(got, want)


@pytest.mark.parametrize("field", [0, 1])
def test_distinct_fastpath_with_active_runs_generic(field):
    cols = make_cols(300, seed=430 + field)
    jb, tb = both_batches(cols)
    want, wn = jdistinct.distinct(jb, field, JConfig(u32_distinct_engine="fastpath"),
                                  active=jnp.asarray(cols["valid"]))
    got, gn = tdistinct.distinct(tb, field, TConfig(u32_distinct_engine="fastpath"),
                                 active=tb.valid)
    assert int(gn) == int(wn) > 0
    assert_same_batch(got, want)


@pytest.mark.parametrize("field", [2, 3])
def test_merge_join_fastpath_other_fields_run_generic(field):
    jb, tb, jp, tp = tables(300, seed=440 + field)
    want, wn, wstats = jmerge.merge_join(jb, jp, field, JConfig(u32_distinct_engine="fastpath"))
    got, gn, gstats = tmerge.merge_join(tb, tp, field, TConfig(u32_distinct_engine="fastpath"))
    assert int(gn) == int(wn) > 0
    assert {k: int(v) for k, v in gstats.items()} == {k: int(v) for k, v in wstats.items()}
    assert_same_batch(got, want)


@pytest.mark.parametrize("field", [0, 1])
def test_unknown_join_engine_on_u32_fields_raises_as_jax(field):
    jb, tb, jp, tp = tables(50, seed=470)
    with pytest.raises(ValueError, match="unknown u32_join_engine"):
        jhash.hash_join_count(jb, jp, field, JConfig(u32_join_engine="nosuch"))
    with pytest.raises(ValueError, match="unknown u32_join_engine"):
        thash.hash_join_count(tb, tp, field, TConfig(u32_join_engine="nosuch"))


@pytest.mark.parametrize("field", [2, 3])
def test_unknown_engines_on_other_fields_run_generic(field):
    jb, tb, jp, tp = tables(200, seed=480 + field)
    wm, _, wn = jhash.hash_join_count(jb, jp, field, JConfig(u32_join_engine="nosuch"))
    gm, _, gn = thash.hash_join_count(tb, tp, field, TConfig(u32_join_engine="nosuch"))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert int(gn) == int(wn)
    want, wn = jdistinct.distinct(jb, field, JConfig(u32_distinct_engine="nosuch"))
    got, gn = tdistinct.distinct(tb, field, TConfig(u32_distinct_engine="nosuch"))
    assert int(gn) == int(wn)
    assert_same_batch(got, want)


# ---------------------------------------------------------------------------
# the engines on fields 0 and 1

jext = importlib.import_module("database_technology_algorithms_tpu.external")
jtable = importlib.import_module(JOPS + "hash_table")
jbucket = importlib.import_module(JOPS + "bucket_join")
EMPTY_PAIR = (0xDBDF60C1, 0x331DA083)  # mixes to 0xFFFFFFFE, 0xFFFFFFFF


def same_count(got, want):
    """Two (matched, mult, nres) results are equal."""
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


def count_both(jb, tb, jp, tp, field, engine, bc=None, pc=None, **cfg):
    """hash_join_count in both packages under `engine`; the port's result,
    which must equal JAX's and the port's generic engine's."""
    want = jhash.hash_join_count(jb, jp, field, JConfig(u32_join_engine=engine, **cfg),
                                 build_count=None if bc is None else jnp.int32(bc),
                                 probe_count=None if pc is None else jnp.int32(pc))
    got = thash.hash_join_count(tb, tp, field, TConfig(u32_join_engine=engine, **cfg),
                                build_count=bc, probe_count=pc)
    same_count(got, want)
    same_count(got, thash.hash_join_count(tb, tp, field, TConfig(), build_count=bc,
                                          probe_count=pc))
    return got


def key_cols(keys, seed: int = 0) -> dict:
    """Columns whose recid and num are both `keys`."""
    g = np.random.default_rng(seed)
    keys = np.asarray(keys, dtype=np.uint32)
    n = len(keys)
    strs = np.zeros((n, 128), dtype=np.uint8)
    strs[:, :3] = np.frombuffer(b"xyz", dtype=np.uint8)[g.integers(0, 3, size=(n, 3))]
    return {"recid": keys, "num": keys.copy(), "strs": strs, "valid": g.random(n) > 0.1}


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("engine", JOIN_ENGINES)
@pytest.mark.parametrize("field", [0, 1])
def test_join_engines_match_jax(field, engine, counts):
    jb, tb, jp, tp = tables(300, seed=500 + field)
    bc, pc = (250, 380) if counts else (None, None)
    assert int(count_both(jb, tb, jp, tp, field, engine, bc, pc)[2]) > 0


@pytest.mark.parametrize("engine,nb,npr", [
    ("bucketed", 16, 16), ("bucketed", 16, 17), ("bucketed", 256, 255),
    ("bucketed", 257, 100), ("bucketed", 1023, 1025), ("table", 8, 9), ("table", 9, 8),
    ("table", 512, 600), ("searchsorted", 1, 1), ("searchsorted", 2, 1025)])
def test_join_engines_at_layout_steps_match_jax(engine, nb, npr):
    """Sizes on both sides of ``_bucket_layout``'s and ``table_size_for``'s
    steps (16 * 2^k rows; 2 * n at a power of two)."""
    jb, tb = both_batches(make_cols(nb, seed=510 + nb))
    jp, tp = both_batches(make_cols(npr, seed=511 + npr))
    count_both(jb, tb, jp, tp, 1, engine)
    count_both(jb, tb, jp, tp, 0, engine, bc=nb - nb // 3, pc=npr // 2)


@pytest.mark.parametrize("engine", JOIN_ENGINES)
@pytest.mark.parametrize("field", [0, 1])
def test_join_engines_u32_edge_keys_match_jax(field, engine):
    """Keys on both sides of 2^31, 0 and a live 0xFFFFFFFF at the build's
    live count - 1, with 0xFFFFFFFF and probe keys in the padding too."""
    g = np.random.default_rng(520 + field)
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
                    dtype=np.uint32)
    bkeys = np.concatenate([g.choice(pool[:-1], 60), [0xFFFFFFFF], [0xFFFFFFFF, 5, 0x80000000]])
    pkeys = np.concatenate([g.choice(np.append(pool, [5, 6]), 90), [0xFFFFFFFF, 5]])
    jb, tb = both_batches(key_cols(bkeys, 1))
    jp, tp = both_batches(key_cols(pkeys, 2))
    got = count_both(jb, tb, jp, tp, field, engine, bc=61, pc=90)
    assert bool(got[0][np.flatnonzero(pkeys[:90] == 0xFFFFFFFF)].all())
    count_both(jb, tb, jp, tp, field, engine, bc=60, pc=92)  # 0xFFFFFFFF dead, 5 live
    count_both(jb, tb, jp, tp, field, engine)


@pytest.mark.parametrize("engine", JOIN_ENGINES)
def test_join_engines_sentinel_keys_match_jax(engine):
    """``tests/test_placement.py``'s bucketed case, every engine: keys equal
    to the table fill planted on both sides, with and without live counts."""
    g = np.random.default_rng(530)
    b_cols = M.random_cols(g, 700, key_range=300)
    p_cols = M.random_cols(g, 900, key_range=300)
    b_cols["num"][3] = 0xFFFFFFFF
    p_cols["num"][7] = 0xFFFFFFFF
    jb, tb = both_batches(b_cols)
    jp, tp = both_batches(p_cols)
    for field in (0, 1):
        count_both(jb, tb, jp, tp, field, engine)
        count_both(jb, tb, jp, tp, field, engine, bc=650, pc=830)


@pytest.mark.parametrize("engine", JOIN_ENGINES)
def test_join_engines_all_equal_build_match_jax(engine):
    """``tests/test_placement.py``'s overflow case: every build key equal, so
    the bucketed engine's one bucket overflows and it takes its fallback."""
    n = 64 * jbucket._BUCKET_SLACK * jbucket._TARGET_MEAN
    b_cols = key_cols(np.full(n, 77, np.uint32), 3)
    b_cols["recid"] = np.arange(n, dtype=np.uint32)
    p_cols = key_cols(np.where(np.arange(200) % 2 == 0, 77, 5), 4)
    p_cols["recid"] = np.arange(200, dtype=np.uint32)
    jb, tb = both_batches(b_cols)
    jp, tp = both_batches(p_cols)
    assert int(count_both(jb, tb, jp, tp, 1, engine)[2]) == 100
    count_both(jb, tb, jp, tp, 1, engine, bc=n - 9, pc=151)


@pytest.mark.parametrize("engine", JOIN_ENGINES)
@pytest.mark.parametrize("field", [0, 1])
def test_hash_join_rows_under_engines_match_jax(field, engine):
    jb, tb, jp, tp = tables(300, seed=540 + field)
    want, wn = jhash.hash_join(jb, jp, field, JConfig(u32_join_engine=engine))
    got, gn = thash.hash_join(tb, tp, field, TConfig(u32_join_engine=engine))
    assert int(gn) == int(wn) > 0
    assert_same_batch(got, want)


@pytest.mark.parametrize("count", [None, 170])
@pytest.mark.parametrize("field", [0, 1])
def test_distinct_fastpath_matches_jax(field, count):
    jb, tb = both_batches(make_cols(300, seed=550 + field))
    cfg = dict(u32_distinct_engine="fastpath")
    want, wn = jdistinct.distinct(jb, field, JConfig(**cfg),
                                  count=None if count is None else jnp.int32(count))
    got, gn = tdistinct.distinct(tb, field, TConfig(**cfg), count=count)
    assert int(gn) == int(wn) > 0
    assert_same_batch(got, want)
    generic, _ = tdistinct.distinct(tb, field, TConfig(), count=count)
    for c in ("recid", "num", "strw", "valid"):
        assert torch.equal(getattr(got, c), getattr(generic, c))


@pytest.mark.parametrize("field", [0, 1])
def test_merge_join_fastpath_matches_jax(field):
    jb, tb, jp, tp = tables(300, seed=560 + field)
    want, wn, wstats = jmerge.merge_join(jb, jp, field, JConfig(u32_distinct_engine="fastpath"))
    got, gn, gstats = tmerge.merge_join(tb, tp, field, TConfig(u32_distinct_engine="fastpath"))
    assert int(gn) == int(wn) > 0
    assert {k: int(v) for k, v in gstats.items()} == {k: int(v) for k, v in wstats.items()}
    assert_same_batch(got, want)


@pytest.mark.parametrize("engine", JOIN_ENGINES)
def test_external_hash_join_under_engines_matches_jax(engine, tmp_path):
    """The external route's semi-join (``_stream_semi_join``) reaches the
    engines through the in-budget ``hash_join_count``, at a 400-row budget."""
    g = np.random.default_rng(570)
    build = M.random_cols(g, 700, key_range=150)
    probe = M.random_cols(g, 900, key_range=150)
    probe["num"][::5] |= np.uint32(1 << 31)
    chunks = [[{k: v[i: i + 200] for k, v in c.items()} for i in range(0, len(c["recid"]), 200)]
              for c in (build, probe)]
    jout = list(jext.external_hash_join(iter(chunks[0]), iter(chunks[1]), 1,
                                        str(tmp_path / "jax"), mem_rows=400,
                                        cfg=JConfig(u32_join_engine=engine)))
    tout = list(text.external_hash_join(iter(chunks[0]), iter(chunks[1]), 1,
                                        str(tmp_path / "port"), mem_rows=400, device="cpu",
                                        cfg=TConfig(u32_join_engine=engine)))
    assert len(tout) == len(jout) > 0
    for jc, tc in zip(jout, tout):
        for k in jc:
            np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)


@pytest.mark.parametrize("field", [0, 1])
def test_table_engine_empty_pair_equals_generic(field):
    """The key whose mix is 0xFFFFFFFF probed against a build side holding
    only the key whose mix is 0xFFFFFFFE, and the other way round: the port
    answers as the generic engine; the JAX table finds the absent key."""
    present, absent = EMPTY_PAIR
    for build_keys, probe_keys in (([present], [absent, present]),
                                   ([absent], [present, absent]),
                                   ([present, absent], [absent, present, 7])):
        jb, tb = both_batches(key_cols(build_keys, 5))
        jp, tp = both_batches(key_cols(probe_keys, 6))
        want = [k in build_keys for k in probe_keys]
        got = thash.hash_join_count(tb, tp, field, TConfig(u32_join_engine="table"))
        assert got[0].tolist() == want
        same_count(got, jhash.hash_join_count(jb, jp, field, JConfig()))
    jm = jhash.hash_join_count(*both_batches(key_cols([present]))[:1],
                               both_batches(key_cols([absent]))[0], field,
                               JConfig(u32_join_engine="table"))[0]
    assert bool(np.asarray(jm)[0])  # the reference's fault, which the port does not copy


def test_table_engine_probe_bound_below_64_is_exact():
    """Under ``hash_max_probe`` 2 the JAX table misses keys stored further
    than two slots from home; the port's build counts them as failed and
    answers by the exact fallback, as the generic engine does."""
    size = jtable.table_size_for(40)
    keys = [int(k) for k in inverse_mix(7 + size * np.arange(40, dtype=np.uint64))]
    jb, tb = both_batches(key_cols(keys, 7))
    got = thash.hash_join_count(tb, tb, 1, TConfig(u32_join_engine="table", hash_max_probe=2))
    assert got[0].all() and int(got[2]) == 40
    jm = jhash.hash_join_count(jb, jb, 1, JConfig(u32_join_engine="table", hash_max_probe=2))[0]
    assert not np.asarray(jm).all()  # the reference's fault


@pytest.mark.parametrize("nkeys", [64, 65, 200])
def test_table_engine_clustered_keys_match_jax(nkeys):
    """Keys built with the inverse of ``_mix`` so that all share one home
    slot: past 64 of them the build fails and both packages take the
    searchsorted fallback."""
    size = jtable.table_size_for(nkeys)
    keys = inverse_mix(3 + size * np.arange(nkeys, dtype=np.uint64))
    jb, tb = both_batches(key_cols(keys, 8))
    jp, tp = both_batches(key_cols(np.concatenate([keys[::2], [1, 2, 3]]), 9))
    got = count_both(jb, tb, jp, tp, 1, "table")
    assert int(got[2]) == len(keys[::2])
    hs, n_failed = ttable.build_hash_set(tb.num, size)
    assert int(n_failed) == max(nkeys - 64, 0)


@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("field", [0, 1, 2, 3])
def test_build_key_multiset_and_probe_multiplicity_match_jax(field, counts):
    jb, tb, jp, tp = tables(200, seed=580 + field)
    bc, pc = (150, 260) if counts else (None, None)
    jw = jhash.build_key_multiset(jb, field, JConfig(),
                                  count=None if bc is None else jnp.int32(bc))
    tw = thash.build_key_multiset(tb, field, TConfig(), count=bc)
    assert int(tw[2]) == int(jw[2]) > 0
    assert_same_batch(tw[0], jw[0])
    np.testing.assert_array_equal(tw[1].numpy(), np.asarray(jw[1]))
    jm = jhash.probe_multiplicity(*jw, jp, field, JConfig(),
                                  probe_count=None if pc is None else jnp.int32(pc))
    tm = thash.probe_multiplicity(*tw, tp, field, TConfig(), probe_count=pc)
    np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm[0]))
    np.testing.assert_array_equal(tm[1].numpy(), np.asarray(jm[1]))
    assert int(tm[1].sum()) > 0

