"""The PyTorch port's placement route against the JAX package, bit for bit.

``EngineConfig(materialize="sort")`` and ``"sort2d"`` move rows to the rank
of their destination (the JAX package's placement sorts; the port's K1 rank
sort with a K4 or K12 gather).  The same numpy inputs, made from a seed, go
through both packages: JAX on the CPU (conftest), the port on CPU tensors,
where every kernel wrapper runs its plain torch version.  Every value is an
integer or a bool, so every comparison is exact (tolerance: max abs err 0).
The cases follow ``tests/test_placement.py``, which holds the JAX package's
placement engine equal to its gather engine.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu.models import pipeline as jpipe
from database_technology_algorithms_tpu.ops import movement as jmove
from database_technology_algorithms_tpu.ops import sort as jsort
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.models import pipeline as tpipe
from database_technology_algorithms_tpu_torch.ops import distinct as tdistinct
from database_technology_algorithms_tpu_torch.ops import hash_join as thash
from database_technology_algorithms_tpu_torch.ops import merge_join as tmerge
from database_technology_algorithms_tpu_torch.ops import movement as tmove
from database_technology_algorithms_tpu_torch.ops import sort as tsort

# the JAX ops package re-exports functions named like these modules
JOPS = "database_technology_algorithms_tpu.ops."
jdistinct = importlib.import_module(JOPS + "distinct")
jhash = importlib.import_module(JOPS + "hash_join")
jmerge = importlib.import_module(JOPS + "merge_join")

FIELDS = [0, 1, 2, 3]
ROUTES = ["sort", "sort2d"]
CPU = torch.device("cpu")


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


def u32(a) -> np.ndarray:
    """A port word (int32 bits) or a JAX array as numpy u32."""
    if isinstance(a, torch.Tensor):
        return torch_to_u32(a)
    return np.asarray(a).astype(np.uint32)


def make_cols(n: int, seed: int, k: int = 4) -> dict:
    """Duplicate-heavy columns: keys from a pool over the whole u32 range
    (a third >= 2^31), strings of exactly k words (3 shared 8-byte prefixes,
    two trailing letters, so string keys repeat and tie on the JAX prefix),
    about 10% of rows valid=False."""
    g = np.random.default_rng(seed)
    pool = np.random.default_rng(1234).integers(0, 2**32, size=max(n // 3, 2), dtype=np.uint64)
    pool = pool.astype(np.uint32)
    pool[::3] |= np.uint32(1 << 31)
    strs = np.zeros((n, 128), dtype=np.uint8)
    prefixes = np.frombuffer(b"abcdefghabcdefgzQRSTUVWX", dtype=np.uint8).reshape(3, 8)
    strs[:, :8] = prefixes[g.integers(0, 3, size=n)]
    strs[:, 8: 4 * k] = ord("c")  # no NUL before the last word
    strs[:, 4 * k - 2: 4 * k] = np.frombuffer(b"ab", dtype=np.uint8)[g.integers(0, 2, size=(n, 2))]
    return {
        "recid": pool[::-1][g.integers(0, len(pool), size=n)],
        "num": pool[g.integers(0, len(pool), size=n)],
        "strs": strs,
        "valid": g.random(n) > 0.1,
    }


def both_batches(cols: dict) -> tuple[JBatch, TBatch]:
    jb = JBatch.from_numpy(cols["recid"], cols["num"], cols["strs"], cols["valid"])
    tb = TBatch.from_jax_arrays(
        *(np.asarray(c) for c in (jb.recid, jb.num, jb.strw, jb.valid)), device="cpu")
    return jb, tb


def assert_same_batch(got: TBatch, want: JBatch):
    for k in ("recid", "num", "strw"):
        np.testing.assert_array_equal(u32(getattr(got, k)), u32(getattr(want, k)), err_msg=k)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid), err_msg="valid")


def assert_same_words(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(u32(a), u32(b))


def random_words(n: int, m: int, seed: int) -> list[np.ndarray]:
    g = np.random.default_rng(seed)
    return [g.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) for _ in range(m)]


# ---------------------------------------------------------------------------
# the engine choice


def test_use_sort_placement_engines():
    for engine, want in (("sort", True), ("sort2d", True), ("gather", False)):
        assert tmove.use_sort_placement(TConfig(materialize=engine)) is want
        assert jmove.use_sort_placement(JConfig(materialize=engine)) is want
    # "auto" is the gather route on every torch device, as on JAX's CPU backend
    assert tmove.use_sort_placement(TConfig()) is False
    assert jmove.use_sort_placement(JConfig()) is False
    for mod, cfg in ((tmove, TConfig(materialize="scatter")), (jmove, JConfig(materialize="scatter"))):
        with pytest.raises(ValueError, match="unknown materialize"):
            mod.use_sort_placement(cfg)


def test_auto_takes_the_gather_route():
    """Under "auto" stage A hands stage B the gather route's words and the
    operators give the gather route's result."""
    _, tb = both_batches(make_cols(200, seed=3))
    out = tpipe.make_pipeline_staged(1).stage_a(tb, tb)
    assert set(out) >= {"perm", "matched"} and "matched_r" not in out and "dest" not in out
    a, na = tdistinct.distinct(tb, 1)
    b, nb = tdistinct.distinct(tb, 1, TConfig(materialize="gather"))
    assert int(na) == int(nb)
    for x, y in zip((a.recid, a.num, a.strw, a.valid), (b.recid, b.num, b.strw, b.valid)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        tsort.sort_batch(tb, 1, TConfig(materialize="scatter"))


# ---------------------------------------------------------------------------
# the placements (tests/test_placement.py:47-78,197-245,452-473)


@pytest.mark.parametrize("spread", ["dense", "sparse"])
def test_place_words_matches_jax(spread):
    g = np.random.default_rng(7)
    n = 777 if spread == "dense" else 100
    dest = g.permutation(n).astype(np.uint32)
    if spread == "sparse":
        dest = dest * 7 + 3  # not dense: rows land in dest rank order
    words = random_words(n, 9, seed=n)
    want = jmove.place_words(jnp.asarray(dest), [jnp.asarray(w) for w in words])
    got = tmove.place_words(t32(dest), [t32(w) for w in words])
    assert_same_words(got, want)
    order = np.argsort(dest)
    for w, o in zip(words, got):
        np.testing.assert_array_equal(u32(o), w[order])


@pytest.mark.parametrize("case", ["npay1", "npay2", "npay5", "cnt"])
def test_place_words_2d_matches_jax(case):
    g = np.random.default_rng(11)
    n, m, cnt, npay = (512, 4, 100, 1) if case == "cnt" else (1024, 33, None, int(case[-1]))
    dest = g.permutation(n).astype(np.uint32)
    words = random_words(n, m, seed=m)
    want = jmove.place_words_2d(jnp.asarray(dest), None if cnt is None else jnp.int32(cnt),
                                [jnp.asarray(w) for w in words], npay=npay)
    got = tmove.place_words_2d(t32(dest), cnt, [t32(w) for w in words], npay=npay)
    assert_same_words(got, want)
    for w, o in zip(words, got):
        expect = np.empty(n, np.uint32)
        expect[dest] = w
        if cnt is not None:
            expect[cnt:] = 0
        np.testing.assert_array_equal(u32(o), expect)


def test_place_grouped_matches_jax():
    """33 words across the JAX package's 7-word groups, positions >= cnt zero."""
    g = np.random.default_rng(13)
    n, cnt = 640, 200
    dest = g.permutation(n).astype(np.uint32)
    words = random_words(n, 33, seed=33)
    want = jmove.place_grouped(jnp.asarray(dest), jnp.int32(cnt), [jnp.asarray(w) for w in words])
    got = tmove.place_grouped(t32(dest), cnt, [t32(w) for w in words])
    assert len(got) == 33
    assert_same_words(got, want)
    want7 = jmove.place_group(jnp.asarray(dest), jnp.int32(cnt), *[jnp.asarray(w) for w in words[:7]])
    assert_same_words(tmove.place_group(t32(dest), torch.tensor(cnt), *[t32(w) for w in words[:7]]),
                      want7)


@pytest.mark.parametrize("cnt", [None, 400])
def test_place_batch_matches_jax(cnt):
    cols = make_cols(600, seed=17)
    cols["valid"][::3] = False
    jb, tb = both_batches(cols)
    dest = np.random.default_rng(19).permutation(600).astype(np.uint32)
    want = jmove.place_batch(jnp.asarray(dest), None if cnt is None else jnp.int32(cnt), jb)
    got = tmove.place_batch(t32(dest), cnt, tb)
    assert_same_batch(got, want)
    # the payload-word form of the JAX package gives the same batch
    ref = jmove.place_grouped(jnp.asarray(dest), jnp.int32(600 if cnt is None else cnt),
                              jb.payload_words())
    assert_same_batch(got, JBatch.from_payload_words(ref))
    assert_same_words(tb.payload_words(), jb.payload_words())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("use_count", [False, True])
def test_permute_rows_matches_jax(route, use_count):
    cols = make_cols(101, seed=23)
    jb, tb = both_batches(cols)
    keep = np.random.default_rng(29).random(101) < 0.4
    jdest, jcount = jmove.compaction_dest(jnp.asarray(keep))
    tdest, tcount = tmove.compaction_dest(torch.from_numpy(keep))
    want = jmove.permute_rows(jb, jdest, jcount if use_count else None, JConfig(materialize=route))
    got = tmove.permute_rows(tb, tdest, tcount if use_count else None, TConfig(materialize=route))
    assert_same_batch(got, want)
    c = int(keep.sum())
    np.testing.assert_array_equal(u32(got.recid)[:c], cols["recid"][keep])
    if use_count:
        assert not got.valid[c:].any() and not got.strw[c:].any()


# ---------------------------------------------------------------------------
# the pieces of the direct placements


def test_packed_keep_backsort_matches_jax():
    g = np.random.default_rng(31)
    n = 900
    perm = g.permutation(n).astype(np.int32)
    keep = g.random(n) < 0.3
    for n_front in (n, 500, 0):
        want = jmove.packed_keep_backsort(jnp.asarray(perm), jnp.asarray(keep), n_front)
        got = tmove.packed_keep_backsort(torch.from_numpy(perm), torch.from_numpy(keep), n_front)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 700])
def test_survivor_dest_matches_jax(n):
    g = np.random.default_rng(37 + n)
    perm = g.permutation(n).astype(np.int32)
    keep = g.random(n) < 0.4
    wdest, wcount = jsort.survivor_dest(jnp.asarray(perm), jnp.asarray(keep))
    gdest, gcount = tsort.survivor_dest(torch.from_numpy(perm), torch.from_numpy(keep))
    assert int(gcount) == int(wcount)
    np.testing.assert_array_equal(gdest.numpy(), np.asarray(wdest))


@pytest.mark.parametrize("key_plane", ["none", "recid", "num"])
def test_place_join_by_key_matches_jax(key_plane):
    """The matched rows' keys are unique, as every caller gives them; the
    unmatched rows repeat keys and carry valid=False."""
    cols = make_cols(500, seed=41)
    col = "num" if key_plane == "none" else key_plane
    g = np.random.default_rng(43)
    uniq, first = np.unique(cols[col], return_index=True)
    matched = np.zeros(500, bool)
    matched[first[g.random(len(first)) < 0.6]] = True
    jb, tb = both_batches(cols)
    cnt = int(matched.sum())
    want = jmove.place_join_by_key(jnp.asarray(matched), getattr(jb, col), jnp.int32(cnt), jb,
                                   key_plane=key_plane)
    got = tmove.place_join_by_key(torch.from_numpy(matched), getattr(tb, col), cnt, tb,
                                  key_plane=key_plane)
    assert_same_batch(got, want)
    assert 0 < cnt < 500 and not got.valid.numpy()[:cnt].all()  # live rows keep valid=False


@pytest.mark.parametrize("stable_iota", [True, False])
def test_sort_words_matches_jax(stable_iota):
    g = np.random.default_rng(47)
    n = 800
    # unique two-word keys with repeats in each word, a third >= 2^31
    flat = g.permutation(n).astype(np.uint32)
    hi = (flat // 50) | np.where(flat % 3 == 0, np.uint32(1 << 31), np.uint32(0))
    keys = [hi.astype(np.uint32), (flat % 50).astype(np.uint32)]
    pay = random_words(n, 2, seed=5)
    wk, wp = jmove.sort_words([jnp.asarray(k) for k in keys], tuple(jnp.asarray(p) for p in pay),
                              stable_iota=stable_iota)
    gk, gp = tmove.sort_words([t32(k) for k in keys], tuple(t32(p) for p in pay),
                              stable_iota=stable_iota)
    assert_same_words(gk, wk)
    assert_same_words(gp, wp)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("route", ROUTES)
def test_join_preserves_valid_matches_jax(route, packed):
    """tests/test_placement.py:476: a live row with valid=False that matches
    keeps valid=False in the join output."""
    n = 64
    r = {"recid": np.arange(n, dtype=np.uint32), "num": np.arange(n, dtype=np.uint32) * 3,
         "strs": np.zeros((n, 8), np.uint8), "valid": np.ones(n, bool)}
    r["valid"][::4] = False
    s = {"recid": np.arange(n, dtype=np.uint32) + 1000, "num": np.arange(n, dtype=np.uint32) * 3,
         "strs": np.zeros((n, 8), np.uint8), "valid": np.ones(n, bool)}
    (jr, tr), (js, ts) = both_batches(r), both_batches(s)
    want, wn = jmerge.join_sorted_distinct_impl(
        jr, jnp.int32(n), js, jnp.int32(n), 1, JConfig(materialize=route, packed_u32_sorts=packed))
    got, gn = tmerge.join_sorted_distinct_impl(
        tr, n, ts, n, 1, TConfig(materialize=route, packed_u32_sorts=packed))
    assert int(gn) == int(wn) == n
    assert_same_batch(got, want)
    np.testing.assert_array_equal(got.valid.numpy(), r["valid"])


# ---------------------------------------------------------------------------
# the operators (tests/test_placement.py:81-121,169-177,560-587)


@pytest.mark.parametrize("field", [0, 1])
def test_sort_batch_fused_k4_matches_jax(field):
    """The JAX package's fused whole-record sort at K = 4 (its 4 + K <= 8
    gate), with and without a live count."""
    cols = make_cols(500, seed=53, k=4)
    jb, tb = both_batches(cols)
    assert tb.str_words == 4
    for count in (None, 300):
        want, wperm = jsort.sort_batch(jb, field, JConfig(materialize="sort"),
                                       None if count is None else jnp.int32(count))
        got, perm = tsort.sort_batch(tb, field, TConfig(materialize="sort"), count)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
        assert_same_batch(got, want)


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("field", FIELDS)
def test_sort_batch_matches_jax(field, route, k):
    jb, tb = both_batches(make_cols(263, seed=59 + k, k=k))
    assert tb.str_words == k
    for count in (None, 200):
        want, wperm = jsort.sort_batch(jb, field, JConfig(materialize=route),
                                       None if count is None else jnp.int32(count))
        got, perm = tsort.sort_batch(tb, field, TConfig(materialize=route), count)
        np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
        assert_same_batch(got, want)


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("field", FIELDS)
def test_distinct_matches_jax(field, route, k):
    cols = make_cols(263, seed=61 + k, k=k)
    jb, tb = both_batches(cols)
    jcfg, tcfg = JConfig(materialize=route), TConfig(materialize=route)
    for count, active in ((None, None), (200, cols["valid"])):
        want, wn = jdistinct.distinct(jb, field, jcfg, None if count is None else jnp.int32(count),
                                      None if active is None else jnp.asarray(active))
        got, gn = tdistinct.distinct(tb, field, tcfg, count,
                                     None if active is None else torch.from_numpy(active))
        assert int(gn) == int(wn)
        assert_same_batch(got, want)
    assert 1 < int(wn) < 263


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("field", FIELDS)
def test_merge_join_matches_jax(field, route, k):
    jr, tr = both_batches(make_cols(210, seed=67, k=k))
    js, ts = both_batches(make_cols(190, seed=71, k=k))
    want, wn, wstats = jmerge.merge_join(jr, js, field, JConfig(materialize=route))
    got, gn, gstats = tmerge.merge_join(tr, ts, field, TConfig(materialize=route))
    assert int(gn) == int(wn)
    assert {k: int(v) for k, v in gstats.items()} == {k: int(v) for k, v in wstats.items()}
    assert_same_batch(got, want)
    assert 0 < int(wn) < 190


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("field", FIELDS)
def test_join_sorted_distinct_matches_jax(field, route):
    jcfg, tcfg = JConfig(materialize=route), TConfig(materialize=route)
    jr, tr = both_batches(make_cols(300, seed=73))
    js, ts = both_batches(make_cols(250, seed=79))
    jrd, jnr = jdistinct.distinct(jr, field, jcfg)
    jsd, jns = jdistinct.distinct(js, field, jcfg)
    trd, tnr = tdistinct.distinct(tr, field, tcfg)
    tsd, tns = tdistinct.distinct(ts, field, tcfg)
    want, wn = jmerge.join_sorted_distinct(jrd, jnr, jsd, jns, field, jcfg)
    got, gn = tmerge.join_sorted_distinct(trd, tnr, tsd, tns, field, tcfg)
    assert int(gn) == int(wn) > 0
    assert_same_batch(got, want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("field", FIELDS)
def test_hash_join_matches_jax(field, route):
    jb, tb = both_batches(make_cols(170, seed=83))
    jp, tp = both_batches(make_cols(170, seed=89))
    want, wn = jhash.hash_join(jb, jp, field, JConfig(materialize=route))
    got, gn = thash.hash_join(tb, tp, field, TConfig(materialize=route))
    assert int(gn) == int(wn)
    assert_same_batch(got, want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", [1, 300])
def test_compact_rows_matches_jax(n, route):
    jb, tb = both_batches(make_cols(n, seed=97 + n))
    g = np.random.default_rng(n)
    keep = g.random(n) < 0.3
    extra = random_words(n, 2, seed=n)
    want, wn, wex = jmove.compact_rows(jb, jnp.asarray(keep), tuple(jnp.asarray(e) for e in extra),
                                       JConfig(materialize=route))
    got, gn, gex = tmove.compact_rows(tb, torch.from_numpy(keep), tuple(t32(e) for e in extra),
                                      TConfig(materialize=route))
    assert int(gn) == int(wn) == int(keep.sum())
    assert_same_batch(got, want)
    assert_same_words(gex, wex)  # the placed extras: kept rows first, then the dropped


# ---------------------------------------------------------------------------
# the pipelines (tests/test_placement.py:180-194)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("field", FIELDS)
def test_pipeline_single_matches_jax(field, route):
    r_cols, s_cols = make_cols(310, seed=101), make_cols(290, seed=103)
    r_cols["valid"][::7] = False
    (jr, tr), (js, ts) = both_batches(r_cols), both_batches(s_cols)
    want = jpipe.pipeline_single(jr, js, field, JConfig(materialize=route))
    got = tpipe.pipeline_single_impl(tr, ts, field, TConfig(materialize=route))
    for k in ("nunique_r", "nunique_s", "merge_nres", "hash_nres", "agg_groups", "join_count"):
        assert int(got[k]) == int(want[k]), k
    for k in ("count", "sum", "min", "max"):
        np.testing.assert_array_equal(u32(got["aggs"][k]), u32(want["aggs"][k]), err_msg=k)
    assert_same_batch(got["join_out"], want["join_out"])
    assert int(want["merge_nres"]) > 0


STAGE_B_KEYS = {"gather": {"perm", "matched"}, "direct": {"matched_r"}, "dest": {"dest"}}


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("route", ["sort", "sort2d", "gather"])
@pytest.mark.parametrize("field", FIELDS)
def test_staged_pipeline_matches_jax(field, route, k):
    """Counters, join output and the words stage A hands stage B, per
    route: the direct placement for fields 0 and 1 under "sort" at
    4 + K <= 8, destinations otherwise."""
    r_cols, s_cols = make_cols(400, seed=107, k=k), make_cols(350, seed=109, k=k)
    (jr, tr), (js, ts) = both_batches(r_cols), both_batches(s_cols)
    jrun = jpipe.make_pipeline_staged(field, JConfig(materialize=route))
    trun = tpipe.make_pipeline_staged(field, TConfig(materialize=route))
    want, got = jrun(jr, js), trun(tr, ts)
    for key in ("nunique_r", "nunique_s", "merge_nres", "hash_nres", "agg_groups", "join_count"):
        assert int(got[key]) == int(want[key]), key
    assert_same_batch(got["join_out"], want["join_out"])
    assert int(want["merge_nres"]) > 0
    wa, ga = jrun.stage_a(jr, js), trun.stage_a(tr, ts)
    kind = ("gather" if route == "gather"
            else "direct" if route == "sort" and field in (0, 1) and k == 4 else "dest")
    counters = {"nunique_r", "nunique_s", "merge_nres", "hash_nres", "cnt"}
    assert set(ga) == set(wa) == counters | STAGE_B_KEYS[kind]
    for key in sorted(set(ga)):
        np.testing.assert_array_equal(u32(ga[key]), u32(wa[key]), err_msg=key)
    assert_same_batch(trun.materialize(ga, tr, ts), jrun.materialize(wa, jr, js))


@pytest.mark.parametrize("route", ROUTES)
def test_staged_pipeline_over_budget_matches_jax(route):
    """Beyond cfg.mem_rows the staged runner composes the chunked distinct
    (placement route inside each in-budget piece), the tiled join and the
    chunked compaction, whose gather chunks serve every engine."""
    r_cols, s_cols = make_cols(300, seed=113), make_cols(280, seed=127)
    (jr, tr), (js, ts) = both_batches(r_cols), both_batches(s_cols)
    want = jpipe.make_pipeline_staged(1, JConfig(materialize=route, mem_rows=400))(jr, js)
    got = tpipe.make_pipeline_staged(1, TConfig(materialize=route, mem_rows=400))(tr, ts)
    for key in ("nunique_r", "nunique_s", "merge_nres", "hash_nres", "agg_groups", "join_count"):
        assert int(got[key]) == int(want[key]), key
    assert_same_batch(got["join_out"], want["join_out"])
    assert int(want["merge_nres"]) > 0
