"""The PyTorch port's over-budget route against the JAX package, bit for bit.

Inputs are made from a seed with numpy and handed to both packages; JAX
runs on the CPU (conftest), the port on CPU tensors (each kernel's plain
torch version).  Both packages get an ``EngineConfig`` with the same
``mem_rows``, far below the row counts, so the chunked sort and distinct,
the tiled hash join with its retry and the over-budget staged pipeline all
run.  Every value is an integer or a bool, so every comparison is exact
(tolerance 0).
"""

import functools
import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu.models import pipeline as jpipe
from database_technology_algorithms_tpu.ops import keys as jkeys
from database_technology_algorithms_tpu.ops import movement as jmove
from database_technology_algorithms_tpu.ops import sort as jsort
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.kernels.member_mult import member_multiplicity_cells
from database_technology_algorithms_tpu_torch.models import pipeline as tpipe
from database_technology_algorithms_tpu_torch.ops import chunked as tchunked
from database_technology_algorithms_tpu_torch.ops import distinct as tdistinct
from database_technology_algorithms_tpu_torch.ops import hash_join as thash
from database_technology_algorithms_tpu_torch.ops import keys as tkeys
from database_technology_algorithms_tpu_torch.ops import movement as tmove
from database_technology_algorithms_tpu_torch.ops import sort as tsort
from database_technology_algorithms_tpu_torch.utils.checks import MemoryBudgetError
from test_torch_operators import assert_same_batch, both_batches, make_cols, t32

# the JAX ops package re-exports functions named like these modules
JOPS = "database_technology_algorithms_tpu.ops."
jdistinct = importlib.import_module(JOPS + "distinct")
jhash = importlib.import_module(JOPS + "hash_join")

FIELDS = [0, 1, 2, 3]
BUDGETS = [64, 512]
COUNTERS = ("nunique_r", "nunique_s", "merge_nres", "hash_nres", "agg_groups", "join_count")


def u32(g, shape, zero_share=0.0):
    """Random u32 words over the whole range (half of them >= 2^31)."""
    a = g.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    if zero_share:
        a[g.random(shape) < zero_share] = 0
    return a


def same_u32(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(torch_to_u32(got), np.asarray(want).astype(np.uint32))


def all_equal_cols(n: int, seed: int) -> dict:
    """Every key field equal in every row but recid, which counts up."""
    cols = make_cols(n, seed, strings="short")
    cols["num"][:] = 7
    cols["strs"][:] = np.frombuffer(b"same".ljust(128, b"\0"), np.uint8)
    cols["recid"] = np.arange(n, dtype=np.uint32)
    return cols


# ---------------------------------------------------------------------------
# K8: hash_words and key_hash


@pytest.mark.parametrize("skip", [None, 0, 1])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", [1, 2, 3, 9, 33])
def test_hash_words_matches_jax(m, seed, skip):
    g = np.random.default_rng(100 * m + seed)
    words = u32(g, (m, 700), zero_share=0.3)  # zero words in and before the skipped range
    want = jkeys.hash_words([jnp.asarray(w) for w in words], seed, skip)
    got = tkeys.hash_words([t32(w) for w in words], seed, skip)
    assert got.dtype == torch.int32
    same_u32(got, want)
    assert (np.asarray(want) >= 2**31).any()  # the unsigned range is exercised


def test_hash_words_refuses_the_seeds_jax_refuses():
    """``uint32(seed * 0x9E3779B9)`` of a Python int overflows above seed 1
    in the JAX package; the port raises the same error."""
    w = np.arange(5, dtype=np.uint32)
    with pytest.raises(OverflowError):
        jkeys.hash_words([jnp.asarray(w)], 7)
    with pytest.raises(OverflowError):
        tkeys.hash_words([t32(w)], 7)
    with pytest.raises(ValueError):
        tkeys.hash_words([])


@pytest.mark.parametrize("strings", ["tie", "short"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("field", FIELDS)
def test_key_hash_matches_jax(field, seed, strings):
    jb, tb = both_batches(make_cols(900, seed=3, strings=strings))
    same_u32(tkeys.key_hash(tb, field, seed), jkeys.key_hash(jb, field, seed))


@pytest.mark.parametrize("field", FIELDS)
def test_key_hash_is_the_same_at_two_and_four_words(field):
    cols = make_cols(900, seed=4, strings="short")
    cols["num"][::7] = 0  # a zero num word still hashes (field 3)
    jb, tb = both_batches(cols)
    assert tb.str_words == 2
    pad = torch.zeros((tb.nrows, 2), dtype=torch.int32)
    wide = TBatch(recid=tb.recid, num=tb.num, strw=torch.cat([tb.strw, pad], 1), valid=tb.valid)
    assert wide.str_words == 4
    narrow_hash = tkeys.key_hash(tb, field)
    assert torch.equal(tkeys.key_hash(wide, field), narrow_hash)
    same_u32(narrow_hash, jkeys.key_hash(jb, field))


# ---------------------------------------------------------------------------
# K9: value_boundaries and stage_to_cells


@pytest.mark.parametrize("n", [1, 777])
@pytest.mark.parametrize("nprobes", [1, 17, 1024, 1025, 3000])  # JAX switches form at 1024
def test_value_boundaries_matches_jax(nprobes, n):
    g = np.random.default_rng(nprobes + n)
    d = g.integers(0, nprobes + 5, size=n).astype(np.uint32)
    d[::11] = 0xF0000000  # far above every probe, and >= 2^31
    same_u32(tmove.value_boundaries(t32(d), nprobes),
             jmove.value_boundaries(jnp.asarray(d), nprobes))


@pytest.mark.parametrize("npay", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("overflows", [False, True])
@pytest.mark.parametrize("row_map", ["slots", "si", "none"])
@pytest.mark.parametrize("nparts", [2, 37])
def test_stage_to_cells_matches_jax(nparts, row_map, overflows, masked, npay):
    n = 600
    g = np.random.default_rng(nparts + 7 * npay)
    dest = g.integers(0, nparts + 3, size=n).astype(np.uint32)  # some rows out of range
    dest[: n // 4] = 1  # one crowded cell
    active = g.random(n) < 0.85 if masked else np.ones(n, bool)
    pay = u32(g, (npay, n))
    cap = 8 if overflows else n
    want = jmove.stage_to_cells(jnp.asarray(dest), jnp.asarray(active), nparts, cap,
                                [jnp.asarray(w) for w in pay], row_map)
    got = tmove.stage_to_cells(t32(dest), torch.from_numpy(active) if masked else None,
                               nparts, cap, [t32(w) for w in pay], row_map)
    assert (int(want[3]) > 0) == overflows
    assert int(got[3]) == int(want[3])
    same_u32(got[1], want[1])
    assert len(got[0]) == npay
    for a, b in zip(got[0], want[0]):
        same_u32(a, b)
    if row_map == "none":
        assert got[2] is None and want[2] is None
    else:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_stage_to_cells_refuses_bad_arguments():
    d = t32(np.zeros(4, np.uint32))
    with pytest.raises(ValueError):
        tmove.stage_to_cells(d, None, 2, 4, [d], "rows")
    with pytest.raises(ValueError):
        tmove.stage_to_cells(d, None, 0, 4, [d])


# ---------------------------------------------------------------------------
# K10: member_multiplicity


@pytest.mark.parametrize("sizes", [(300, 500), (40_000, 30_000)], ids=["small", "above_2_16"])
@pytest.mark.parametrize("m", [1, 2, 3, 33])
def test_member_multiplicity_matches_jax(m, sizes):
    nb, nk = sizes
    g = np.random.default_rng(m + nb)
    pool = max(nb // 3, 2)
    shared = u32(g, (pool, m))  # one pool of m-word keys: they repeat, and the sides match
    bwords = shared[g.integers(0, pool, size=nb)].T.copy()
    kwords = shared[g.integers(0, pool, size=nk)].T.copy()
    n_bkeys = nb - nb // 5  # the build rows past it are dead
    live = g.random(nk) < 0.8
    want = jhash.member_multiplicity([jnp.asarray(w) for w in bwords], jnp.int32(n_bkeys),
                                     [jnp.asarray(w) for w in kwords], jnp.asarray(live))
    got = thash.member_multiplicity([t32(w) for w in bwords], n_bkeys,
                                    [t32(w) for w in kwords], torch.from_numpy(live))
    same_u32(got, want)
    assert int(got.max()) > 1 and int((got == 0).sum()) > 0  # counts, not flags


@pytest.mark.parametrize("m", [1, 3])
def test_member_multiplicity_cells_matches_vmapped_jax(m):
    """The batched form the tiled join uses: G cell pairs at once."""
    g = np.random.default_rng(m)
    G, cap_b, cap_k = 6, 40, 56
    shared = u32(g, (12, m))
    bw = shared[g.integers(0, 12, size=(G, cap_b))]  # [G, cap_b, m]
    kw = shared[g.integers(0, 12, size=(G, cap_k))]
    nb = np.array([0, cap_b, 7, 1, cap_b, 20], np.int32)
    nk = np.array([cap_k, 0, 9, cap_k, 30, 1], np.int32)

    def one_pair(b, k, cb, ck):
        live = jnp.arange(cap_k, dtype=jnp.int32) < ck
        return jhash.member_multiplicity(list(b), cb, list(k), live)

    want = jax.vmap(one_pair)(
        tuple(jnp.asarray(bw[..., j]) for j in range(m)),
        tuple(jnp.asarray(kw[..., j]) for j in range(m)), jnp.asarray(nb), jnp.asarray(nk))
    got = member_multiplicity_cells(
        [t32(bw[..., j]) for j in range(m)], torch.from_numpy(nb),
        [t32(kw[..., j]) for j in range(m)], torch.from_numpy(nk))
    same_u32(got, want)
    assert not got[1].any() and not got[0].any()  # no query rows, no build rows


# ---------------------------------------------------------------------------
# the tiling geometry


@pytest.mark.parametrize("cap_mult", [1, 2, 8])
@pytest.mark.parametrize("mem_rows", [1, 64, 512, 1 << 20, 1 << 24])
def test_tile_layout_matches_jax(mem_rows, cap_mult):
    sizes = [0, 1, 63, 100, 5000, 16384, 10**6, 24 * 10**6]
    for nb in sizes:
        for npr in sizes:
            got = thash._tile_layout(nb, npr, mem_rows, cap_mult)
            assert got == jhash._tile_layout(nb, npr, mem_rows, cap_mult)
            ntiles, cap_b, cap_p, group = got
            assert ntiles % group == 0 and ntiles & (ntiles - 1) == 0
    assert [thash._next_pow2(x) for x in (0, 1, 2, 3, 4097)] == [1, 1, 2, 4, 8192]


# ---------------------------------------------------------------------------
# the tiled hash join


def join_pair(strings="tie"):
    build = make_cols(700, seed=21, strings=strings)
    probe = make_cols(900, seed=22, strings=strings)
    return both_batches(build), both_batches(probe)


@pytest.mark.parametrize("counts", [False, True], ids=["all_rows", "counts"])
@pytest.mark.parametrize("mem_rows", BUDGETS)
@pytest.mark.parametrize("field", FIELDS)
def test_hash_join_count_over_budget_matches_jax(field, mem_rows, counts):
    (jb, tb), (jp, tp) = join_pair()
    jkw = dict(build_count=jnp.int32(500), probe_count=jnp.int32(650)) if counts else {}
    tkw = dict(build_count=torch.tensor(500, dtype=torch.int32),
               probe_count=torch.tensor(650, dtype=torch.int32)) if counts else {}
    want = jhash.hash_join_count(jb, jp, field, JConfig(mem_rows=mem_rows), **jkw)
    got = thash.hash_join_count(tb, tp, field, TConfig(mem_rows=mem_rows), **tkw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    same_u32(got[1], want[1])
    assert int(got[2]) == int(want[2]) > 0
    if field == 3:
        assert int(got[1].max()) > 1  # build multiplicities, not flags
        assert int(got[2]) == int(got[1].sum())
    else:
        assert int(got[1].max()) == 1
    if counts:
        assert not got[0][650:].any()
    with pytest.raises(MemoryBudgetError):
        thash.hash_join_count_impl(tb, tp, field, TConfig(mem_rows=mem_rows))


@pytest.mark.parametrize("mem_rows", BUDGETS)
@pytest.mark.parametrize("field", FIELDS)
def test_hash_join_over_budget_matches_jax(field, mem_rows):
    (jb, tb), (jp, tp) = join_pair("short")
    want, want_n = jhash.hash_join(jb, jp, field, JConfig(mem_rows=mem_rows))
    got, got_n = thash.hash_join(tb, tp, field, TConfig(mem_rows=mem_rows))
    assert int(got_n) == int(want_n) > 0
    assert_same_batch(got, want)
    with pytest.raises(MemoryBudgetError):
        thash.hash_join_impl(tb, tp, field, TConfig(mem_rows=mem_rows))


@pytest.mark.parametrize("field", [2, 3])
def test_hash_join_over_budget_cross_width_strings(field):
    """Build strings stored in 2 words, probe strings in 4: the narrower
    side's key words are zero-padded, and probe rows that only share the
    build's first 8 bytes do not match."""
    g = np.random.default_rng(9)
    nb, npr = 500, 700
    bs = np.zeros((nb, 8), np.uint8)
    bs[:, :5] = g.integers(97, 100, size=(nb, 5), dtype=np.uint8)
    ps = np.zeros((npr, 16), np.uint8)
    ps[:, :12] = g.integers(97, 100, size=(npr, 12), dtype=np.uint8)
    ps[:50, :5] = bs[0, :5]  # share a build row's 5 bytes, then go on: no match
    ps[50:90] = 0
    ps[50:90, :5] = bs[g.integers(0, nb, size=40), :5]  # true matches
    num_b = g.integers(0, 3, nb).astype(np.uint32)
    num_p = g.integers(0, 3, npr).astype(np.uint32)
    jb = JBatch.from_numpy(np.arange(nb, dtype=np.uint32), num_b, bs, np.ones(nb, bool))
    jp = JBatch.from_numpy(np.arange(npr, dtype=np.uint32), num_p, ps, np.ones(npr, bool))
    assert jb.str_words == 2 and jp.str_words == 4
    tb, tp = (TBatch.from_jax_arrays(*(np.asarray(c) for c in (b.recid, b.num, b.strw, b.valid)),
                                     device="cpu") for b in (jb, jp))
    want = jhash.hash_join_count(jb, jp, field, JConfig(mem_rows=512))
    got = thash.hash_join_count(tb, tp, field, TConfig(mem_rows=512))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    same_u32(got[1], want[1])
    assert 0 < int(got[2]) == int(want[2])
    assert not got[0][:50].any() or field == 3  # shared prefixes alone never match


def test_hash_join_over_budget_wide_keys():
    """(num, 32 string words): 33-word keys ride the cells."""
    g = np.random.default_rng(5)
    n = 300
    strs = np.zeros((n, 128), np.uint8)
    strs[:, :80] = g.integers(97, 123, size=(n, 80), dtype=np.uint8)
    strs[50:60] = strs[0]
    num = np.full(n, 3, np.uint32)
    jb = JBatch.from_numpy(np.arange(n, dtype=np.uint32), num, strs, np.ones(n, bool))
    tb = TBatch.from_jax_arrays(*(np.asarray(c) for c in (jb.recid, jb.num, jb.strw, jb.valid)),
                                device="cpu")
    assert tb.str_words == 32
    want = jhash.hash_join_count(jb, jb, 3, JConfig(mem_rows=256))
    got = thash.hash_join_count(tb, tb, 3, TConfig(mem_rows=256))
    same_u32(got[1], want[1])
    assert int(got[2]) == int(want[2]) == n + 10 * 10 + 10  # rows 0, 50-59 are 11 copies


@pytest.mark.parametrize("field", [1, 3])
def test_hash_join_retry_is_bounded_and_logged(field, caplog):
    """All keys equal: one cell gets every row and overflows; the capacity
    doubles until the cell holds a whole side, each overflow is logged, and
    the result equals the JAX package's."""
    n = 300
    (jb, tb), (jp, tp) = both_batches(all_equal_cols(n, 1)), both_batches(all_equal_cols(n, 2))
    cfg = TConfig(mem_rows=512)
    ntiles = thash._tile_layout(n, n, cfg.mem_rows)[0]
    with caplog.at_level(logging.INFO, logger=thash.log.name):
        got = thash.hash_join_count(tb, tp, field, cfg)
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    done = [r for r in caplog.records if r.levelno == logging.INFO]
    assert 1 <= len(warnings) <= ntiles.bit_length() - 1
    assert all("overflowed" in r.getMessage() for r in warnings)
    assert len(done) == 1 and f"{len(warnings) + 1} attempts" in done[0].getMessage()
    want = jhash.hash_join_count(jb, jp, field, JConfig(mem_rows=512))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    same_u32(got[1], want[1])
    assert int(got[2]) == int(want[2]) == (n * n if field == 3 else n)


def test_hash_join_retry_gives_up_after_its_last_attempt(monkeypatch):
    """An attempt that reports overflow at every capacity ends in an error
    after log2(ntiles) + 1 attempts instead of looping."""
    (_, tb), (_, tp) = join_pair("short")
    calls = []

    def always_overflows(build, probe, field, cfg, bc, pc, cap_mult):
        calls.append(cap_mult)
        z = torch.zeros(probe.nrows, dtype=torch.int32)
        return z > 0, z, z.sum(), torch.tensor(1)

    monkeypatch.setattr(thash, "_tiled_count_impl", always_overflows)
    cfg = TConfig(mem_rows=512)
    ntiles = thash._tile_layout(tb.nrows, tp.nrows, cfg.mem_rows)[0]
    with pytest.raises(RuntimeError, match="still overflow"):
        thash.hash_join_count(tb, tp, 1, cfg)
    assert calls == [1 << i for i in range(ntiles.bit_length())]


@pytest.mark.parametrize("field", [1, 3])
def test_hash_join_retry_stops_where_cells_cannot_be_addressed(field, monkeypatch, caplog):
    """The number of cells is fixed while their capacity doubles: a skewed
    input whose next attempt's one cell would pass the slot limit of the
    staging kernel raises an error that names the skew, and that attempt is
    never made.  The rounds narrow first (cap_mult 1 in rounds of two cells,
    2 in rounds of one)."""
    from database_technology_algorithms_tpu_torch.kernels import cells_plan

    n = 300
    (_, tb), (_, tp) = both_batches(all_equal_cols(n, 1)), both_batches(all_equal_cols(n, 2))
    cfg = TConfig(mem_rows=512)
    ntiles, cap_b, cap_p, _ = thash._tile_layout(n, n, cfg.mem_rows, 2)
    monkeypatch.setattr(cells_plan, "MAX_SLOTS", max(cap_b, cap_p))  # a cell at cap_mult 2 fits
    with caplog.at_level(logging.WARNING, logger=thash.log.name):
        with pytest.raises(RuntimeError, match=r"too skewed for 300 \+ 300 rows.*cap_mult=4"):
            thash.hash_join_count(tb, tp, field, cfg)
    assert len(caplog.records) == 2  # cap_mult 1 and 2 ran and overflowed


# ---------------------------------------------------------------------------
# the tiled hash join in rounds (K9 stages at most cells_plan.MAX_STAGE_BINS - 1
# cells a call): the cell limit made small so that the rounds run at CPU sizes


def force_rounds(monkeypatch, nb: int, npr: int, mem_rows: int, nrounds: int,
                 cap_mult: int = 1) -> list:
    """Shrink K9's cell limit so that the tiled join of nb + npr rows under
    `mem_rows` stages its cells in `nrounds` rounds; returns the list that
    records each K9 call's (cells, row map)."""
    from database_technology_algorithms_tpu_torch.kernels import cells_plan

    ntiles, cap_b, cap_p, _ = thash._tile_layout(nb, npr, mem_rows, cap_mult)
    assert ntiles % nrounds == 0 and ntiles // nrounds >= 1
    monkeypatch.setattr(cells_plan, "MAX_STAGE_BINS", ntiles // nrounds + 1)
    assert cells_plan.round_width(nb, npr, ntiles, cap_b, cap_p) == ntiles // nrounds
    calls, stage = [], thash.stage_to_cells

    def record(dest, active, nparts, cap, payloads, row_map="slots", **kw):
        calls.append((nparts, row_map))
        return stage(dest, active, nparts, cap, payloads, row_map=row_map, **kw)

    monkeypatch.setattr(thash, "stage_to_cells", record)
    return calls


@functools.cache
def jax_join_count(field: int, mem_rows: int, counts: bool):
    (jb, _), (jp, _) = join_pair()
    kw = dict(build_count=jnp.int32(500), probe_count=jnp.int32(650)) if counts else {}
    want = jhash.hash_join_count(jb, jp, field, JConfig(mem_rows=mem_rows), **kw)
    return tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("counts", [False, True], ids=["all_rows", "counts"])
@pytest.mark.parametrize("mem_rows", BUDGETS)
@pytest.mark.parametrize("field", FIELDS)
def test_hash_join_count_in_rounds_matches_jax(field, mem_rows, counts, monkeypatch):
    """Four rounds of a quarter of the cells each: the counts, the match
    mask and nres equal the JAX package's, which stages every cell at once."""
    (_, tb), (_, tp) = join_pair()
    calls = force_rounds(monkeypatch, tb.nrows, tp.nrows, mem_rows, 4)
    tkw = dict(build_count=torch.tensor(500, dtype=torch.int32),
               probe_count=torch.tensor(650, dtype=torch.int32)) if counts else {}
    got = thash.hash_join_count(tb, tp, field, TConfig(mem_rows=mem_rows), **tkw)
    want = jax_join_count(field, mem_rows, counts)
    ntiles = thash._tile_layout(tb.nrows, tp.nrows, mem_rows)[0]
    # four rounds an attempt (field 2's tied strings overflow and retry)
    assert calls and calls == [(ntiles // 4, "none"), (ntiles // 4, "slots")] * (len(calls) // 2)
    assert len(calls) % 8 == 0
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    same_u32(got[1], want[1])
    assert int(got[2]) == int(want[2]) > 0
    if counts:
        assert not got[0][650:].any()


@pytest.mark.parametrize("mem_rows", BUDGETS)
@pytest.mark.parametrize("field", FIELDS)
def test_hash_join_in_rounds_matches_jax(field, mem_rows, monkeypatch):
    (jb, tb), (jp, tp) = join_pair("short")
    calls = force_rounds(monkeypatch, tb.nrows, tp.nrows, mem_rows, 2)
    want, want_n = jhash.hash_join(jb, jp, field, JConfig(mem_rows=mem_rows))
    got, got_n = thash.hash_join(tb, tp, field, TConfig(mem_rows=mem_rows))
    assert calls and len(calls) % 4 == 0  # two rounds an attempt
    assert int(got_n) == int(want_n) > 0
    assert_same_batch(got, want)


@pytest.mark.parametrize("field", [1, 3])
def test_hash_join_retry_in_rounds_matches_jax(field, monkeypatch, caplog):
    """All keys equal: the one full cell overflows in its round, the
    overflow summed over the rounds discards the attempt, and the retries
    with doubled capacity end equal to the JAX package."""
    n = 300
    (jb, tb), (jp, tp) = both_batches(all_equal_cols(n, 1)), both_batches(all_equal_cols(n, 2))
    cfg = TConfig(mem_rows=512)
    calls = force_rounds(monkeypatch, n, n, cfg.mem_rows, 2)
    ntiles = thash._tile_layout(n, n, cfg.mem_rows)[0]
    with caplog.at_level(logging.WARNING, logger=thash.log.name):
        got = thash.hash_join_count(tb, tp, field, cfg)
    assert 1 <= len(caplog.records) <= ntiles.bit_length() - 1
    assert len(calls) == 4 * (len(caplog.records) + 1)  # two rounds an attempt
    want = jhash.hash_join_count(jb, jp, field, JConfig(mem_rows=512))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    same_u32(got[1], want[1])
    assert int(got[2]) == int(want[2]) == (n * n if field == 3 else n)


def test_cells_past_k9_take_rounds_on_every_device():
    """65,536 cells (20,000 + 20,000 rows under mem_rows=2) pass K9's limit:
    the attempt is not refused, it takes two rounds of 32,768, on the CPU as
    on the card; the join equals the in-budget one."""
    from database_technology_algorithms_tpu_torch.kernels import cells_plan

    cols_b, cols_p = make_cols(20000, seed=41, strings="short"), make_cols(20000, seed=42,
                                                                            strings="short")
    (_, tb), (_, tp) = both_batches(cols_b), both_batches(cols_p)
    cfg = TConfig(mem_rows=2)
    ntiles, cap_b, cap_p, _ = thash._tile_layout(tb.nrows, tp.nrows, cfg.mem_rows)
    assert ntiles == 65536 > cells_plan.MAX_STAGE_BINS - 1
    assert cells_plan.round_width(tb.nrows, tp.nrows, ntiles, cap_b, cap_p) == 32768
    thash._ensure_cells_fit(tb, tp, 1, cfg, 1)
    got = thash.hash_join_count(tb, tp, 1, cfg)
    want = thash.hash_join_count_impl(tb, tp, 1, TConfig())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert int(got[2]) == int(want[2]) > 0


def test_tiled_join_refuses_only_what_no_round_avoids(monkeypatch):
    """A side past K9's 32-bit rows (its limit made small here) is refused
    before any attempt, on every device, naming the rows, not the skew."""
    from database_technology_algorithms_tpu_torch.kernels import cells_plan

    (_, tb), (_, tp) = join_pair()
    monkeypatch.setattr(cells_plan, "MAX_ROWS", 800)
    with pytest.raises(RuntimeError, match=r"700 \+ 900 rows; K9 stages at most"):
        thash.hash_join_count(tb, tp, 1, TConfig(mem_rows=512))


# ---------------------------------------------------------------------------
# the chunked sort and distinct


def chunked_cols(kind: str) -> dict:
    if kind == "all_equal":
        return all_equal_cols(1500, 3)
    cols = make_cols(1500, seed=31, strings="tie")
    if kind == "dominant":  # one key takes 90% of the rows: the splitter sample collapses
        cols["num"][150:] = 7
        cols["recid"][150:] = 7
        cols["strs"][150:] = cols["strs"][0]
    return cols


@pytest.mark.parametrize("kind", ["mixed", "dominant", "all_equal"])
@pytest.mark.parametrize("mem_rows", BUDGETS)
@pytest.mark.parametrize("field", FIELDS)
def test_sort_batch_over_budget_matches_jax(field, mem_rows, kind):
    jb, tb = both_batches(chunked_cols(kind))
    for count in (None, 900):
        want, want_perm = jsort.sort_batch(jb, field, JConfig(mem_rows=mem_rows), count=count)
        got, got_perm = tsort.sort_batch(tb, field, TConfig(mem_rows=mem_rows), count=count)
        np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
        assert_same_batch(got, want)
    # the in-budget core gives the same order, and refuses this budget
    ref, ref_perm = tsort.sort_batch_impl(tb, field, TConfig(), count=900)
    assert torch.equal(ref_perm, got_perm) and torch.equal(ref.recid, got.recid)
    with pytest.raises(MemoryBudgetError):
        tsort.sort_batch_impl(tb, field, TConfig(mem_rows=mem_rows))


@pytest.mark.parametrize("kind", ["mixed", "dominant", "all_equal"])
@pytest.mark.parametrize("mem_rows", BUDGETS)
@pytest.mark.parametrize("field", FIELDS)
def test_distinct_over_budget_matches_jax(field, mem_rows, kind):
    cols = chunked_cols(kind)
    jb, tb = both_batches(cols)
    active = np.random.default_rng(8).random(len(cols["num"])) < 0.7
    variants = (
        ({}, {}),
        ({"count": 900}, {"count": 900}),
        ({"active": jnp.asarray(active)}, {"active": torch.from_numpy(active)}),
        ({"count": 1100, "active": jnp.asarray(active)},
         {"count": 1100, "active": torch.from_numpy(active)}),
    )
    for jkw, tkw in variants:
        want, want_n = jdistinct.distinct(jb, field, JConfig(mem_rows=mem_rows), **jkw)
        got, got_n = tdistinct.distinct(tb, field, TConfig(mem_rows=mem_rows), **tkw)
        assert int(got_n) == int(want_n) > 0
        assert_same_batch(got, want)
    ref, ref_n = tdistinct.distinct_impl(tb, field, TConfig(), **tkw)
    assert int(ref_n) == int(got_n) and torch.equal(ref.recid, got.recid)
    with pytest.raises(MemoryBudgetError):
        tdistinct.distinct_impl(tb, field, TConfig(mem_rows=mem_rows))


@pytest.mark.parametrize("mem_rows", [1, 64, 5000])
def test_compact_rows_chunked_matches_jax(mem_rows):
    from database_technology_algorithms_tpu.ops import chunked as jchunked

    jb, tb = both_batches(make_cols(1500, seed=33))
    keep = np.random.default_rng(2).random(1500) < 0.4
    if mem_rows == 1:
        keep[:] = False
        keep[[3, 700, 1499]] = True  # one gather a kept row
    want, want_n = jchunked.compact_rows_chunked(jb, keep, JConfig(mem_rows=mem_rows))
    got, got_n = tchunked.compact_rows_chunked(tb, torch.from_numpy(keep),
                                               TConfig(mem_rows=mem_rows))
    assert int(got_n) == int(want_n) == int(keep.sum())
    assert_same_batch(got, want)


def test_searchsorted_rows_matches_jax():
    from database_technology_algorithms_tpu.external import _searchsorted_rows as j_search

    g = np.random.default_rng(6)
    mat = g.integers(0, 4, size=(200, 3)).astype(np.uint32)
    mat = mat[np.lexsort(mat.T[::-1])]
    for split in g.integers(0, 5, size=(40, 3)).astype(np.uint32):
        for side in ("left", "right"):
            assert tchunked._searchsorted_rows(mat, split, side) == j_search(mat, split, side)


# ---------------------------------------------------------------------------
# the over-budget staged pipeline


@pytest.mark.parametrize("mem_rows", BUDGETS)
@pytest.mark.parametrize("field", FIELDS)
def test_staged_pipeline_over_budget_matches_jax(field, mem_rows):
    rc, sc = make_cols(1100, seed=41), make_cols(1300, seed=42)
    # rows that would match but for valid=False must not join or count
    rc["num"][5] = sc["num"][7] = 999
    rc["recid"][5] = sc["recid"][7] = 999
    rc["strs"][5] = sc["strs"][7] = np.frombuffer(b"onlyhere".ljust(128, b"\0"), np.uint8)
    rc["valid"][5] = False
    sc["valid"][7] = True
    rc["valid"][40:60] = False
    sc["valid"][100:140] = False
    (jr, tr), (js, ts) = both_batches(rc), both_batches(sc)
    want = jpipe.make_pipeline_staged(field, JConfig(mem_rows=mem_rows))(jr, js)
    run = tpipe.make_pipeline_staged(field, TConfig(mem_rows=mem_rows))
    got = run(tr, ts)
    for k in COUNTERS:
        assert int(got[k]) == int(want[k]), k
    assert 0 < int(got["merge_nres"]) < 1100
    assert_same_batch(got["join_out"], want["join_out"])
    # the in-budget runner gives the same answer, and its stage refuses this budget
    ref = tpipe.make_pipeline_staged(field, TConfig())(tr, ts)
    assert [int(ref[k]) for k in COUNTERS] == [int(got[k]) for k in COUNTERS]
    assert torch.equal(ref["join_out"].recid, got["join_out"].recid)
    with pytest.raises(MemoryBudgetError):
        run.stage_a(tr, ts)
