"""The PyTorch port's stand-alone operators against the JAX package, bit for bit.

Inputs are made from a seed with numpy and handed to both packages; JAX
runs on the CPU (conftest) under both of its materialization routes where
an operator moves rows, the port on CPU tensors (each kernel's plain torch
version).  Every value is an integer or a bool, so every comparison is
exact (tolerance 0).  The plain versions of the kernels K5-K7 are also held
against numpy directly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu.ops import keys as jkeys
from database_technology_algorithms_tpu.ops import movement as jmove
from database_technology_algorithms_tpu.ops import sort as jsort
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.kernels.adj_equal import adj_equal_plain
from database_technology_algorithms_tpu_torch.kernels.unpermute import unpermute, unpermute_plain
from database_technology_algorithms_tpu_torch.kernels.words_sort import words_sort_plain
from database_technology_algorithms_tpu_torch.ops import distinct as tdistinct
from database_technology_algorithms_tpu_torch.ops import hash_join as thash
from database_technology_algorithms_tpu_torch.ops import keys as tkeys
from database_technology_algorithms_tpu_torch.ops import merge_join as tmerge
from database_technology_algorithms_tpu_torch.ops import movement as tmove
from database_technology_algorithms_tpu_torch.ops import sort as tsort
from database_technology_algorithms_tpu_torch.utils.checks import MemoryBudgetError

# the JAX ops package re-exports functions named like these modules
JOPS = "database_technology_algorithms_tpu.ops."
jdistinct = importlib.import_module(JOPS + "distinct")
jhash = importlib.import_module(JOPS + "hash_join")
jmerge = importlib.import_module(JOPS + "merge_join")

FIELDS = [0, 1, 2, 3]
SIZES = [1, 2, 100, 3000]
ROUTES = ["gather", "sort"]
CPU = torch.device("cpu")


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


def make_cols(n: int, seed: int, strings: str = "tie") -> dict:
    """Duplicate-heavy columns with keys over the whole u32 range (a third
    of the pool >= 2^31) and about 10% invalid rows.

    ``strings="tie"``: 10-byte strings whose first 8 bytes come from three
    prefixes, so many rows tie on the JAX package's 2-word sort prefix with
    different full keys (its exact fallback runs); K = 4.
    ``strings="short"``: 5 bytes over a 3-letter alphabet; the prefix
    resolves every key (its fast path runs); K = 2.
    Two tables made with different seeds share keys: the pools are fixed.
    """
    g = np.random.default_rng(seed)
    pg = np.random.default_rng(1234)
    pool = pg.integers(0, 2**32, size=max(n // 3, 2), dtype=np.uint64).astype(np.uint32)
    pool[::3] |= np.uint32(1 << 31)
    num = pool[g.integers(0, len(pool), size=n)]
    recid = pool[::-1][g.integers(0, len(pool), size=n)]
    strs = np.zeros((n, 128), dtype=np.uint8)
    if strings == "tie":
        prefixes = np.frombuffer(b"abcdefghabcdefgzQRSTUVWX", dtype=np.uint8).reshape(3, 8)
        strs[:, :8] = prefixes[g.integers(0, 3, size=n)]
        strs[:, 8:10] = np.frombuffer(b"ab", dtype=np.uint8)[g.integers(0, 2, size=(n, 2))]
    else:
        strs[:, :5] = np.frombuffer(b"abc", dtype=np.uint8)[g.integers(0, 3, size=(n, 5))]
    return {"recid": recid, "num": num, "strs": strs, "valid": g.random(n) > 0.1}


def both_batches(cols: dict) -> tuple[JBatch, TBatch]:
    jb = JBatch.from_numpy(cols["recid"], cols["num"], cols["strs"], cols["valid"])
    tb = TBatch.from_jax_arrays(
        *(np.asarray(c) for c in (jb.recid, jb.num, jb.strw, jb.valid)), device="cpu")
    return jb, tb


def assert_same_batch(got: TBatch, want: JBatch):
    np.testing.assert_array_equal(torch_to_u32(got.recid), np.asarray(want.recid))
    np.testing.assert_array_equal(torch_to_u32(got.num), np.asarray(want.num))
    np.testing.assert_array_equal(torch_to_u32(got.strw), np.asarray(want.strw))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def assert_same_view(got, want):
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.adj_eq.numpy(), np.asarray(want.adj_eq))
    assert len(got.extras) == len(want.extras)
    for a, b in zip(got.extras, want.extras):
        np.testing.assert_array_equal(torch_to_u32(a), np.asarray(b).astype(np.uint32))


def prefix_under_resolves(cols: dict) -> bool:
    """Some rows share the first 8 string bytes and differ after them."""
    s = cols["strs"]
    full = {bytes(r) for r in s}
    return len({bytes(r[:8]) for r in s}) < len(full)


# ---------------------------------------------------------------------------
# sort_keys


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("variant", ["bare", "mask", "mask_word", "pre_post"])
def test_sort_keys_matches_jax(field, n, variant):
    cols = make_cols(n, seed=10 + n)
    jb, tb = both_batches(cols)
    g = np.random.default_rng(n)
    inact = g.random(n) < 0.2
    extra = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    jkw, tkw = {}, {}
    if variant == "mask":  # the operators' form: an inactivity mask, declared as one
        jkw = dict(pre_words=(jnp.asarray(inact.astype(np.uint32)),), pre_is_mask=True,
                   extra=(jnp.asarray(extra),))
        tkw = dict(pre_words=(torch.from_numpy(inact),), pre_is_mask=True, extra=(t32(extra),))
    elif variant == "mask_word":  # the same mask as an undeclared u32 word
        jkw = dict(pre_words=(jnp.asarray(inact.astype(np.uint32)),),
                   extra=(jnp.asarray(extra), jnp.asarray(cols["num"])))
        tkw = dict(pre_words=(t32(inact),), extra=(t32(extra), t32(cols["num"])))
    elif variant == "pre_post":  # general words on both sides of the key
        pre = g.integers(0, 3, size=n).astype(np.uint32) << 30  # values >= 2^31 among them
        post = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
        post[g.random(n) < 0.5] = 7
        jkw = dict(pre_words=(jnp.asarray(pre),), post_words=(jnp.asarray(post),))
        tkw = dict(pre_words=(t32(pre),), post_words=(t32(post),))
    want = jsort.sort_keys(jb, field, **jkw)
    for cfg in (TConfig(), TConfig(packed_u32_sorts=False)):
        assert_same_view(tsort.sort_keys(tb, field, cfg, **tkw), want)
    if n >= 100:
        assert prefix_under_resolves(cols)  # the JAX result came from its exact fallback
        assert np.asarray(want.adj_eq).any() and not np.asarray(want.adj_eq).all()


@pytest.mark.parametrize("field", [2, 3])
def test_sort_keys_matches_jax_when_the_prefix_resolves(field):
    cols = make_cols(700, seed=3, strings="short")
    assert not prefix_under_resolves(cols)  # the JAX result comes from its fast path
    jb, tb = both_batches(cols)
    assert tb.str_words == 2
    inact = ~cols["valid"]
    want = jsort.sort_keys(jb, field, pre_words=(jnp.asarray(inact.astype(np.uint32)),),
                           extra=(jnp.asarray(cols["recid"]),))
    got = tsort.sort_keys(tb, field, pre_words=(torch.from_numpy(inact),),
                          extra=(t32(cols["recid"]),))
    assert_same_view(got, want)
    np.testing.assert_array_equal(tsort.sort_perm(tb, field).numpy(),
                                  np.asarray(jsort.sort_perm(jb, field)))


@pytest.mark.parametrize("field", FIELDS)
def test_rows_equal_on_field_matches_jax(field):
    n = 500
    jb, tb = both_batches(make_cols(n, seed=5))
    g = np.random.default_rng(field)
    i, j = g.integers(0, n, size=(2, 4 * n)).astype(np.int32)
    j[::7] = i[::7]  # some pairs are the same row
    want = np.asarray(jkeys.rows_equal_on_field(jb, field, jnp.asarray(i), jnp.asarray(j)))
    got = tkeys.rows_equal_on_field(tb, field, torch.from_numpy(i), torch.from_numpy(j))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    assert tkeys.uses_strings(field) == jkeys.uses_strings(field) == (field in (2, 3))


# ---------------------------------------------------------------------------
# sort_batch, is_sorted


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
def test_sort_batch_matches_jax(field, n, route):
    jb, tb = both_batches(make_cols(n, seed=20 + n))
    jcfg = JConfig(materialize=route)
    for count in (None, max(n * 2 // 3, 1)):
        jcount = None if count is None else jnp.int32(count)
        want, wperm = jsort.sort_batch(jb, field, jcfg, jcount)
        got, perm = tsort.sort_batch(tb, field, count=count)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
        assert_same_batch(got, want)
    full, _ = tsort.sort_batch(tb, field)
    assert bool(tsort.is_sorted(full, field))
    if n >= 100:
        assert not bool(tsort.is_sorted(tb, field))
        assert bool(jsort.is_sorted(jb, field)) == bool(tsort.is_sorted(tb, field))


# ---------------------------------------------------------------------------
# distinct


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
def test_distinct_matches_jax(field, n, route):
    cols = make_cols(n, seed=30 + n)
    jb, tb = both_batches(cols)
    jcfg = JConfig(materialize=route)
    count = max(n * 3 // 4, 1)
    active = cols["valid"]
    for use_count, use_active in ((False, False), (True, False), (False, True), (True, True)):
        jk = dict(count=jnp.int32(count) if use_count else None,
                  active=jnp.asarray(active) if use_active else None)
        tk = dict(count=count if use_count else None,
                  active=torch.from_numpy(active) if use_active else None)
        want, wn = jdistinct.distinct(jb, field, jcfg, **jk)
        got, gn = tdistinct.distinct(tb, field, **tk)
        assert int(gn) == int(wn)
        assert_same_batch(got, want)
        # the count may be a device scalar as well as an int
        if use_count and not use_active:
            got2, gn2 = tdistinct.distinct(tb, field, count=torch.tensor(count, dtype=torch.int32))
            assert int(gn2) == int(wn)
            assert_same_batch(got2, want)
    if n >= 100:
        assert 1 < int(wn) < n


@pytest.mark.parametrize("n", [1, 100, 3000])
@pytest.mark.parametrize("field", FIELDS)
def test_distinct_view_and_distinct_sorted_match_jax(field, n):
    jb, tb = both_batches(make_cols(n, seed=40 + n))
    count = max(n // 2, 1)
    wview, wkeep = jdistinct.distinct_view(jb, field, count=jnp.int32(count))
    gview, gkeep = tdistinct.distinct_view(tb, field, count=count)
    assert_same_view(gview, wview)
    np.testing.assert_array_equal(gkeep.numpy(), np.asarray(wkeep))
    js, _ = jsort.sort_batch(jb, field)
    ts, _ = tsort.sort_batch(tb, field)
    np.testing.assert_array_equal(tkeys.adjacent_equal(ts, field).numpy(),
                                  np.asarray(jdistinct.adjacent_equal(js, field)))
    for c in (None, count):
        want, wn = jdistinct.distinct_sorted(js, field, None if c is None else jnp.int32(c))
        got, gn = tdistinct.distinct_sorted(ts, field, c)
        assert int(gn) == int(wn)
        assert_same_batch(got, want)


# ---------------------------------------------------------------------------
# merge join


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
def test_merge_join_matches_jax(field, n, route):
    ns = max(n * 4 // 5, 1)  # sides of different capacity
    jr, tr = both_batches(make_cols(n, seed=50 + n))
    js, ts = both_batches(make_cols(ns, seed=51 + n))
    jcfg = JConfig(materialize=route)
    want, wn, wstats = jmerge.merge_join(jr, js, field, jcfg)
    got, gn, gstats = tmerge.merge_join(tr, ts, field)
    assert int(gn) == int(wn)
    assert {k: int(v) for k, v in gstats.items()} == {k: int(v) for k, v in wstats.items()}
    assert_same_batch(got, want)
    if n >= 100:
        assert 0 < int(wn) < n


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", [2, 100, 3000])
@pytest.mark.parametrize("field", FIELDS)
def test_join_sorted_distinct_matches_jax(field, n, route):
    jr, tr = both_batches(make_cols(n, seed=60 + n))
    js, ts = both_batches(make_cols(n, seed=61 + n))
    jcfg = JConfig(materialize=route)
    jrd, jnr = jdistinct.distinct(jr, field, jcfg)
    jsd, jns = jdistinct.distinct(js, field, jcfg)
    trd, tnr = tdistinct.distinct(tr, field)
    tsd, tns = tdistinct.distinct(ts, field)
    want, wn = jmerge.join_sorted_distinct(jrd, jnr, jsd, jns, field, jcfg)
    got, gn = tmerge.join_sorted_distinct(trd, tnr, tsd, tns, field)
    assert int(gn) == int(wn)
    assert_same_batch(got, want)
    _, wview, wmatched = jmerge.join_view(jrd, jnr, jsd, jns, field)
    _, gview, gmatched = tmerge.join_view(trd, int(tnr), tsd, int(tns), field)
    assert_same_view(gview, wview)
    np.testing.assert_array_equal(gmatched.numpy(), np.asarray(wmatched))


# ---------------------------------------------------------------------------
# hash join


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("counts", [False, True])
def test_hash_join_count_matches_jax(field, n, counts):
    npr = max(n * 3 // 2, 1)
    jb, tb = both_batches(make_cols(n, seed=70 + n))
    jp, tp = both_batches(make_cols(npr, seed=71 + n))
    jk, tk = {}, {}
    if counts:
        bc, pc = max(n // 2, 1), max(npr * 2 // 3, 1)
        jk = dict(build_count=jnp.int32(bc), probe_count=jnp.int32(pc))
        tk = dict(build_count=bc, probe_count=pc)
    wm, wmult, wn = jhash.hash_join_count(jb, jp, field, **jk)
    for cfg in (TConfig(), TConfig(packed_u32_sorts=False)):
        gm, gmult, gn = thash.hash_join_count(tb, tp, field, cfg, **tk)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gmult.numpy(), np.asarray(wmult))
        assert gmult.dtype == torch.int32 and gn.dtype == torch.int32
        assert int(gn) == int(wn)
    if n >= 100 and (field != 2 or counts):  # twelve strings: every live probe row matches
        assert 0 < int(np.asarray(wm).sum()) < npr
        if field == 3:
            assert int(wn) > int(np.asarray(wm).sum())  # build duplicates count


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("field", FIELDS)
def test_hash_join_matches_jax(field, n, route):
    jb, tb = both_batches(make_cols(n, seed=80 + n))
    jp, tp = both_batches(make_cols(max(n // 2, 1), seed=81 + n))
    want, wn = jhash.hash_join(jb, jp, field, JConfig(materialize=route))
    got, gn = thash.hash_join(tb, tp, field)
    assert int(gn) == int(wn)
    assert_same_batch(got, want)


@pytest.mark.parametrize("n", [1, 100, 3000])
def test_materialize_field3_matches_jax(n):
    jb, tb = both_batches(make_cols(n, seed=90 + n))
    jp, tp = both_batches(make_cols(n, seed=91 + n))
    wm, wmult, wn = jhash.hash_join_count(jb, jp, 3)
    gm, gmult, gn = thash.hash_join_count(tb, tp, 3)
    want = jhash.materialize_field3(jp, np.asarray(wm), np.asarray(wmult))
    got = thash.materialize_field3(tp, gm, gmult)
    assert got.nrows == int(gn) == int(wn)
    assert got.recid.device.type == "cpu"
    if got.nrows:
        assert_same_batch(got, want)


# ---------------------------------------------------------------------------
# compaction


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", SIZES)
def test_compact_rows_matches_jax(n, route):
    cols = make_cols(n, seed=95 + n)
    jb, tb = both_batches(cols)
    g = np.random.default_rng(n)
    keep = g.random(n) < 0.4
    extra = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    want, wn, wex = jmove.compact_rows(jb, jnp.asarray(keep), (jnp.asarray(extra),),
                                       JConfig(materialize=route))
    got, gn, gex = tmove.compact_rows(tb, torch.from_numpy(keep), (t32(extra),))
    assert int(gn) == int(wn) == int(keep.sum())
    assert_same_batch(got, want)
    # compacted extras: the kept prefix is defined on every route
    np.testing.assert_array_equal(torch_to_u32(gex[0])[: int(wn)], np.asarray(wex[0])[: int(wn)])
    wdest, wcount = jmove.compaction_dest(jnp.asarray(keep))
    gdest, gcount = tmove.compaction_dest(torch.from_numpy(keep))
    assert int(gcount) == int(wcount)
    np.testing.assert_array_equal(gdest.numpy(), np.asarray(wdest))


# ---------------------------------------------------------------------------
# what is not ported raises


def test_unported_engines_and_routes_raise():
    _, tb = both_batches(make_cols(50, seed=1))
    # the alternative u32 engines run (tests/test_torch_engines.py); the
    # placement route runs (tests/test_torch_placement.py holds it against
    # JAX) and gives the gather route's result
    sort_route = TConfig(materialize="sort")
    for call in (
        lambda cfg: tsort.sort_batch(tb, 2, cfg)[0],
        lambda cfg: tdistinct.distinct(tb, 1, cfg)[0],
        lambda cfg: tmerge.merge_join(tb, tb, 3, cfg)[0],
        lambda cfg: thash.hash_join(tb, tb, 0, cfg)[0],
        lambda cfg: tmove.compact_rows(tb, tb.valid, cfg=cfg)[0],
    ):
        a, b = call(sort_route), call(TConfig())
        for x, y in zip((a.recid, a.num, a.strw, a.valid), (b.recid, b.num, b.strw, b.valid)):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="unknown materialize"):
        tdistinct.distinct(tb, 1, TConfig(materialize="scatter"))
    # beyond the budget the in-budget cores refuse; the public forms route
    # (tests/test_torch_overbudget.py), on the gather route only
    small = TConfig(mem_rows=60)
    for call in (
        lambda: tsort.sort_batch_impl(tb, 1, TConfig(mem_rows=49)),
        lambda: tdistinct.distinct_impl(tb, 1, TConfig(mem_rows=49)),
        lambda: thash.hash_join_count_impl(tb, tb, 1, small),
        lambda: thash.hash_join_impl(tb, tb, 1, small),
    ):
        with pytest.raises(MemoryBudgetError, match="external drivers of external.py"):
            call()
    assert int(tdistinct.distinct(tb, 1, TConfig(mem_rows=49))[1]) == int(
        tdistinct.distinct(tb, 1)[1])
    assert int(thash.hash_join(tb, tb, 1, small)[1]) == int(thash.hash_join(tb, tb, 1)[1])
    # over the budget the chunked route keeps its gather chunks under every engine
    for route in ("sort", "sort2d"):
        got = tsort.sort_batch(tb, 2, TConfig(mem_rows=49, materialize=route))[0]
        assert torch.equal(got.recid, tsort.sort_batch(tb, 2)[0].recid)
        got = thash.hash_join(tb, tb, 0, TConfig(mem_rows=60, materialize=route))[0]
        assert torch.equal(got.recid, thash.hash_join(tb, tb, 0)[0].recid)


# ---------------------------------------------------------------------------
# the plain versions of K5, K6, K7 against numpy


@pytest.mark.parametrize("n", [0, 1, 2, 257, 3000])
@pytest.mark.parametrize("m", [1, 2, 3, 9])
def test_words_sort_plain_matches_numpy_lexsort(n, m):
    g = np.random.default_rng(100 * m + n)
    # strided columns of a row-major matrix, few distinct values, many >= 2^31
    mat = (g.integers(0, 3, size=(n, m)).astype(np.uint32) << 30) | g.integers(
        0, 2, size=(n, m)).astype(np.uint32)
    inact = g.random(n) < 0.25
    extra = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    tmat = t32(mat)
    cols = [tmat[:, j] for j in range(m)]
    assert m == 1 or n < 2 or not cols[0].is_contiguous()
    # np.lexsort: last key is the primary one; row index breaks ties
    keys = [np.arange(n)] + [mat[:, j] for j in reversed(range(m))]
    want = np.lexsort(keys + [inact])
    perm, s_act, (ex,) = words_sort_plain(cols, torch.from_numpy(inact), (t32(extra),))
    assert perm.dtype == torch.int32 and s_act.dtype == torch.bool
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(s_act.numpy(), ~inact[want])
    np.testing.assert_array_equal(torch_to_u32(ex), extra[want])
    perm2, s_act2, _ = words_sort_plain(cols, None)
    np.testing.assert_array_equal(perm2.numpy(), np.lexsort(keys))
    assert bool(s_act2.all())
    # K6's plain version on the same key, through perm and in place
    sorted_rows = mat[want]
    eq = np.concatenate([[False], (sorted_rows[1:] == sorted_rows[:-1]).all(axis=1)])[:n]
    np.testing.assert_array_equal(adj_equal_plain(cols, perm).numpy(), eq)
    eq_in_place = np.concatenate([[False], (mat[1:] == mat[:-1]).all(axis=1)])[:n]
    np.testing.assert_array_equal(adj_equal_plain(cols, None).numpy(), eq_in_place)


@pytest.mark.parametrize("n", [0, 1, 50, 3000])
def test_unpermute_plain_matches_numpy_scatter(n):
    g = np.random.default_rng(n)
    perm = g.permutation(n).astype(np.int32)
    vals = g.integers(-(2**31), 2**31, size=n).astype(np.int32)
    flags = g.random(n) < 0.5
    for lo, m in ((0, n), (n // 3, n - n // 3), (n // 4, n // 2), (n, 0)):
        want_i = np.zeros(n, np.int32)
        want_i[perm] = vals
        want_b = np.zeros(n, bool)
        want_b[perm] = flags
        tperm = torch.from_numpy(perm)
        got_i = unpermute_plain(tperm, torch.from_numpy(vals), lo, m)
        got_b = unpermute(tperm, torch.from_numpy(flags), lo, m)  # CPU: the plain version
        np.testing.assert_array_equal(got_i.numpy(), want_i[lo:lo + m])
        np.testing.assert_array_equal(got_b.numpy(), want_b[lo:lo + m])
        assert got_b.dtype == torch.bool and got_i.dtype == torch.int32
    with pytest.raises(ValueError):
        unpermute(torch.from_numpy(perm), torch.from_numpy(vals), 1, n)
