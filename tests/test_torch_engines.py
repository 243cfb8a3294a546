"""The alternative u32 engines, ``cfg.u32_join_engine`` and
``cfg.u32_distinct_engine``, gated in the port exactly as the JAX package
dispatches on them.

The JAX package leaves its generic path only for key fields 0 and 1 (the
join: ``ops/hash_join.py:516``; distinct: ``"fastpath"`` with no ``active``
mask, ``ops/distinct.py:100-104``).  There the port raises, its engines not
being ported; everywhere else both packages run the generic path and the
port returns JAX's result, bit for bit (inputs made from a seed with numpy,
JAX on the CPU, the port on CPU tensors).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.ops import distinct as tdistinct
from database_technology_algorithms_tpu_torch.ops import hash_join as thash
from database_technology_algorithms_tpu_torch.ops import merge_join as tmerge
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


@pytest.mark.parametrize("engine", JOIN_ENGINES)
@pytest.mark.parametrize("field", [0, 1])
def test_join_engines_on_u32_fields_raise(field, engine):
    _, tb, _, tp = tables(50, seed=450)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thash.hash_join_count(tb, tp, field, TConfig(u32_join_engine=engine))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thash.hash_join(tb, tp, field, TConfig(u32_join_engine=engine))


@pytest.mark.parametrize("field", [0, 1])
def test_distinct_fastpath_on_u32_fields_raises(field):
    _, tb, _, tp = tables(50, seed=460)
    cfg = TConfig(u32_distinct_engine="fastpath")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdistinct.distinct(tb, field, cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmerge.merge_join(tb, tp, field, cfg)


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
