"""The PyTorch port's group-by aggregate against the JAX package, bit for bit.

The same numpy columns, made from a seed, go through the JAX package's
``ops/aggregate.py`` (on the CPU, conftest) and the port's (on CPU tensors,
where every kernel wrapper runs its plain version, K13's included): the
four aggregate columns, ``n_groups`` and the representative rows must be
equal, on the gather route and both placement routes, at fields 0-3.  Keys
and measures carry bit 31, and groups sum past 2^32.

K13's plain version is also held against a numpy emulation of the kernel's
own rule (``csrc/run_aggregate.cu``): warps walk spans of rows 32 at a time,
a group that starts and ends inside a span is stored, the span's first and
last groups commit by atomics into identity-filled columns.  The emulation
checks that no stored group is touched by another span, at the span's edges.
Tolerance everywhere: exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.kernels import run_aggregate as k13
from database_technology_algorithms_tpu_torch.ops import aggregate as tagg

jagg = importlib.import_module("database_technology_algorithms_tpu.ops.aggregate")

FIELDS = [0, 1, 2, 3]
ROUTES = ["gather", "sort", "sort2d"]
AGGS = ("count", "sum", "min", "max")
CPU = torch.device("cpu")
U32_MAX = 0xFFFFFFFF


def make_cols(n: int, seed: int) -> dict:
    """Duplicate-heavy columns: recid and num from pools over the whole u32
    range (a third >= 2^31, so sums of a few wrap past 2^32), strings from a
    small alphabet (two-letter prefixes, field 2 and 3 keys repeat), about
    10% of rows valid=False."""
    g = np.random.default_rng(seed)
    pool = g.integers(0, 2**32, size=max(n // 4, 2), dtype=np.uint64).astype(np.uint32)
    pool[::3] |= np.uint32(1 << 31)
    strs = np.zeros((n, 128), dtype=np.uint8)
    strs[:, :2] = g.integers(97, 100, size=(n, 2), dtype=np.uint8)
    strs[::5, 2:9] = np.frombuffer(b"longish", dtype=np.uint8)
    return {
        "recid": pool[::-1][g.integers(0, len(pool), size=n)],
        "num": pool[g.integers(0, min(len(pool), 7), size=n)],
        "strs": strs,
        "valid": g.random(n) > 0.1,
    }


def both(cols: dict) -> tuple[JBatch, TBatch]:
    jb = JBatch.from_numpy(cols["recid"], cols["num"], cols["strs"], cols["valid"])
    tb = TBatch.from_jax_arrays(
        *(np.asarray(c) for c in (jb.recid, jb.num, jb.strw, jb.valid)), device="cpu")
    return jb, tb


def u32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return torch_to_u32(a)
    return np.asarray(a).astype(np.uint32)


def assert_same_result(got, want):
    """(reps, aggs, n_groups) of the port against JAX's."""
    greps, gaggs, gn = got
    wreps, waggs, wn = want
    assert int(gn) == int(wn)
    for k in ("recid", "num", "strw"):
        np.testing.assert_array_equal(u32(getattr(greps, k)), u32(getattr(wreps, k)), err_msg=k)
    np.testing.assert_array_equal(greps.valid.numpy(), np.asarray(wreps.valid), err_msg="valid")
    assert set(gaggs) == set(waggs) == set(AGGS)
    for k in AGGS:
        assert gaggs[k].dtype == torch.int32
        np.testing.assert_array_equal(u32(gaggs[k]), u32(waggs[k]), err_msg=k)


FORMS = ["none", "count", "active", "both"]


def form_args(form: str, n: int, seed: int):
    """(count, active) as numpy for one liveness form."""
    g = np.random.default_rng(seed)
    count = n * 2 // 3 if form in ("count", "both") else None
    active = g.random(n) < 0.7 if form in ("active", "both") else None
    return count, active


@pytest.mark.parametrize("reps", [True, False])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("field", FIELDS)
def test_group_aggregate_matches_jax(field, route, form, reps):
    n = N
    jb, tb = both(make_cols(n, seed=field * 10 + 1))
    count, active = form_args(form, n, seed=3)
    want = jagg.group_aggregate_impl(
        jb, field, JConfig(materialize=route),
        count=None if count is None else jnp.int32(count),
        active=None if active is None else jnp.asarray(active), materialize_reps=reps)
    got = tagg.group_aggregate(
        tb, field, TConfig(materialize=route), count=count,
        active=None if active is None else torch.from_numpy(active), materialize_reps=reps)
    assert_same_result(got, want)
    if form != "none":  # padding and inactive rows form no group
        assert int(got[2]) < n


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("field", [0, 1])
def test_group_aggregate_u32_sort_gates_match_jax(field, packed):
    """Fields 0-1 sort through K1 under ``packed_u32_sorts`` and through K5
    otherwise; both give JAX's result."""
    jb, tb = both(make_cols(N, seed=5))
    want = jagg.group_aggregate_impl(jb, field, JConfig(packed_u32_sorts=packed),
                                     count=jnp.int32(200))
    got = tagg.group_aggregate_impl(tb, field, TConfig(packed_u32_sorts=packed), count=200)
    assert_same_result(got, want)


N = 240  # one row count for every case, so the JAX side compiles each shape once


def slices_and_partials(pkg, batch, field, cfg, k, count_of):
    """Run `pkg`'s group_aggregate on k slices of `batch`; concatenate each
    slice's live reps and partials in slice order (the local stage of the
    two-phase plan, without the exchange)."""
    n = batch.nrows
    bounds = np.linspace(0, n, k + 1).astype(int)
    reps, parts = [], [[] for _ in AGGS]
    for a, b in zip(bounds[:-1], bounds[1:]):
        r, aggs, ng = pkg.group_aggregate_impl(batch.slice(int(a), int(b - a)), field, cfg)
        ng = int(ng)
        reps.append(r.slice(0, ng))
        for j, name in enumerate(AGGS):
            parts[j].append(count_of(aggs[name])[:ng])
    return reps, parts


def padded(cols: list, n: int, cat, zeros):
    """Concatenate and pad with zero rows to n: a static capacity whose live
    prefix the combine's `count` marks."""
    out = cat(cols)
    return cat([out, zeros(n - out.shape[0], out)])


# (field, slices, route): every field, 2-4 slices, every route
COMBINE_CASES = [(f, k, ROUTES[(f + k) % 3]) for f in FIELDS for k in (2, 3, 4)]


@pytest.mark.parametrize("field,k,route", COMBINE_CASES)
def test_combine_group_aggregate_matches_jax(field, k, route):
    jb, tb = both(make_cols(N, seed=k + 20 * field))
    jcfg, tcfg = JConfig(materialize=route), TConfig(materialize=route)
    jreps, jparts = slices_and_partials(jagg, jb, field, jcfg, k, np.asarray)
    treps, tparts = slices_and_partials(tagg, tb, field, tcfg, k, lambda t: t)
    for jp, tp in zip(jparts, tparts):
        np.testing.assert_array_equal(u32(np.concatenate(jp)), u32(torch.cat(tp)))
    live = sum(r.nrows for r in treps)

    def jzeros(m, like):
        return np.zeros((m,) + like.shape[1:], like.dtype)

    def tzeros(m, like):
        return like.new_zeros((m,) + tuple(like.shape[1:]))

    jcat = JBatch(*(jnp.asarray(padded([np.asarray(getattr(r, c)) for r in jreps], N,
                                       np.concatenate, jzeros))
                    for c in ("recid", "num", "strw", "valid")))
    tcat = TBatch(*(padded([getattr(r, c) for r in treps], N, torch.cat, tzeros)
                    for c in ("recid", "num", "strw", "valid")))
    want = jagg.combine_group_aggregate_impl(
        jcat, field, tuple(jnp.asarray(padded(p, N, np.concatenate, jzeros)) for p in jparts),
        jcfg, count=jnp.int32(live))
    got = tagg.combine_group_aggregate_impl(
        tcat, field, tuple(padded(p, N, torch.cat, tzeros) for p in tparts), tcfg, count=live)
    assert_same_result(got, want)
    # the two phases give the single pass's groups, aggregates and reps
    single = tagg.group_aggregate_impl(tb, field, tcfg)
    ng = int(single[2])
    assert int(got[2]) == ng
    for name in AGGS:
        assert torch.equal(got[1][name][:ng], single[1][name][:ng]), name
    for c in ("recid", "num", "strw", "valid"):
        assert torch.equal(getattr(got[0], c)[:ng], getattr(single[0], c)[:ng]), c


@pytest.mark.parametrize("count", [None, 150])
@pytest.mark.parametrize("route", ["gather", "sort"])
def test_combine_with_count_and_wide_partials_matches_jax(route, count):
    """Partials as given by a caller: u32 counts above 2^31 (summed as int32,
    wrapping) and a live count over padding rows."""
    n = N
    cols = make_cols(n, seed=31)
    jb, tb = both(cols)
    g = np.random.default_rng(32)
    parts = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32) for _ in AGGS]
    parts[0][::3] |= np.uint32(1 << 31)
    want = jagg.combine_group_aggregate_impl(
        jb, 1, tuple(jnp.asarray(p) for p in parts), JConfig(materialize=route),
        count=None if count is None else jnp.int32(count))
    got = tagg.combine_group_aggregate_impl(
        tb, 1, tuple(u32_to_torch(p, CPU) for p in parts), TConfig(materialize=route),
        count=count)
    assert_same_result(got, want)


def special_cols(case: str, n: int) -> dict:
    g = np.random.default_rng(41)
    recid = np.arange(n, dtype=np.uint32)
    if case == "sum wraps":
        recid = (np.arange(n) // 37).astype(np.uint32)
        num = np.full(n, 0xF0000001, dtype=np.uint32)
    elif case == "min max above 2^31":
        recid = (np.arange(n) // 13).astype(np.uint32)
        num = (np.uint32(1 << 31) + g.integers(0, 2**31, size=n)).astype(np.uint32)
        num[::17] = U32_MAX
    elif case == "one group":
        recid = np.full(n, 0x9ABCDEF0, dtype=np.uint32)
        num = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    else:  # every row its own group
        recid = g.permutation(n).astype(np.uint32) | np.uint32(1 << 31)
        num = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    strs = np.zeros((n, 8), dtype=np.uint8)
    strs[:, 0] = 65
    return {"recid": recid, "num": num, "strs": strs, "valid": np.ones(n, bool)}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ["sum wraps", "min max above 2^31", "one group",
                                  "every row its own group"])
def test_group_aggregate_edges_match_jax(case, route):
    n = N
    cols = special_cols(case, n)
    jb, tb = both(cols)
    want = jagg.group_aggregate_impl(jb, 0, JConfig(materialize=route))
    got = tagg.group_aggregate_impl(tb, 0, TConfig(materialize=route))
    assert_same_result(got, want)
    keys, first = np.unique(cols["recid"], return_index=True)
    ng = int(got[2])
    assert ng == len(keys)
    order = np.argsort(cols["recid"], kind="stable")
    starts = np.searchsorted(cols["recid"][order], keys)
    num = cols["num"][order].astype(np.uint64)
    sums = (np.add.reduceat(num, starts) % (1 << 32)).astype(np.uint32)
    np.testing.assert_array_equal(u32(got[1]["sum"])[:ng], sums)
    np.testing.assert_array_equal(u32(got[1]["min"])[:ng], np.minimum.reduceat(num, starts))
    np.testing.assert_array_equal(u32(got[1]["max"])[:ng], np.maximum.reduceat(num, starts))
    if case == "sum wraps":
        assert (np.add.reduceat(num, starts) >= 1 << 32).all()


# ---------------------------------------------------------------------------
# K13's span rule, emulated


def emulate_k13(active, adj, vals, span: int):
    """The kernel's commits, warp span by warp span and 32 rows at a time
    (csrc/run_aggregate.cu).  Returns (aggs, n_groups, stored, atomic): the
    groups committed by store and by atomic, with the spans that did it."""
    n = len(active)
    new_run = active & ~adj
    incl = np.cumsum(new_run, dtype=np.int64)
    if len(vals) == 1:
        vals = (np.ones(n, np.uint32), vals[0], vals[0], vals[0])
    vals = [np.asarray(v, dtype=np.uint64) for v in vals]
    out = [np.zeros(n, np.uint64), np.zeros(n, np.uint64), np.full(n, U32_MAX, np.uint64),
           np.zeros(n, np.uint64)]
    ident = (0, 0, U32_MAX, 0, False)
    stored, atomic = {}, {}

    def combine(a, b):
        return ((a[0] + b[0]) % 2**32, (a[1] + b[1]) % 2**32, min(a[2], b[2]), max(a[3], b[3]),
                a[4] or b[4])

    def commit(g, v, is_atomic, s):
        if not v[4] or g < 0:
            return
        if is_atomic:
            atomic.setdefault(g, []).append(s)
            out[0][g] = (out[0][g] + v[0]) % 2**32
            out[1][g] = (out[1][g] + v[1]) % 2**32
            out[2][g] = min(out[2][g], v[2])
            out[3][g] = max(out[3][g], v[3])
        else:
            assert g not in stored, f"group {g} stored twice"
            stored[g] = s
            for k in range(4):
                out[k][g] = v[k]

    for s0 in range(0, n, span):
        s1 = min(s0 + span, n)
        first = incl[s0] - 1
        cg, carry = first, ident
        for base in range(s0, s1, 32):
            rows = np.arange(base, min(base + 32, s1))
            g = incl[rows] - 1
            v = [(int(vals[0][i]), int(vals[1][i]), int(vals[2][i]), int(vals[3][i]), True)
                 if active[i] else ident for i in rows]
            if g[0] == cg:
                v[0] = combine(v[0], carry)
            else:
                commit(cg, carry, cg == first, s0)
            for lane in range(1, len(rows)):  # the inclusive segmented scan
                if g[lane] == g[lane - 1]:
                    v[lane] = combine(v[lane - 1], v[lane])
            for lane in range(len(rows) - 1):
                if g[lane + 1] != g[lane]:
                    commit(g[lane], v[lane], g[lane] == first, s0)
            cg, carry = g[-1], v[-1]
        commit(cg, carry, True, s0)
    for g in stored:  # a stored group belongs to its span alone
        assert g not in atomic, f"group {g} stored and committed by atomics"
    aggs = {k: out[j].astype(np.uint32) for j, k in enumerate(AGGS)}
    return aggs, int(incl[-1]) if n else 0, stored, atomic


def span_case(case: str, span: int, seed: int):
    """(active, adj, group starts) in sorted order: inactive rows at the tail."""
    g = np.random.default_rng(seed)
    n = {"n = 0": 0, "n = 1": 1, "n not a multiple": 3 * span + 17}.get(case, 4 * span)
    starts = np.zeros(n, bool)
    if case == "random":
        starts = g.random(n) < 0.2
    elif case == "group over several spans":
        starts = g.random(n) < 0.3
        starts[span // 2 + 1: span // 2 + 1 + 2 * span + 40] = False
    elif case == "group starts on a span's last row":
        starts[::span // 4] = True
        starts[span - 1::span] = True
        starts[span::span] = False
    elif case == "every row its own group":
        starts[:] = True
    elif case == "n not a multiple":
        starts = g.random(n) < 0.05
    elif case == "inactive tail in the last span":
        starts = g.random(n) < 0.1
    elif case in ("n = 1", "one group"):
        pass
    if n:
        starts[0] = True
    active = np.ones(n, bool)
    if case in ("inactive tail in the last span", "n not a multiple", "random"):
        active[n - span // 2 - 5:] = False
    if case == "all inactive":
        active[:] = False
    adj = ~starts
    if n:
        adj[0] = False
    # the inactive tail repeats keys (adj True) or not, as a sort leaves it
    tail = ~active
    adj[tail] = g.random(int(tail.sum())) < 0.5
    return active, adj


SPAN_CASES = ["random", "group over several spans", "group starts on a span's last row",
              "every row its own group", "one group", "n not a multiple",
              "inactive tail in the last span", "all inactive", "n = 0", "n = 1"]


@pytest.mark.parametrize("measures", [1, 4])
@pytest.mark.parametrize("span", [32, 64, k13.SPAN_ROWS])
@pytest.mark.parametrize("case", SPAN_CASES)
def test_k13_span_rule_matches_plain(case, span, measures):
    active, adj = span_case(case, span, seed=len(case) + span)
    n = len(active)
    g = np.random.default_rng(span + measures)
    vals = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(measures)]
    if n:
        vals[0][::3] |= np.uint32(1 << 31)
    want, wn = k13.run_aggregate_plain(
        torch.from_numpy(active), torch.from_numpy(adj), tuple(u32_to_torch(v, CPU) for v in vals))
    got, gn, stored, atomic = emulate_k13(active, adj, vals, span)
    assert gn == int(wn)
    for k in AGGS:
        np.testing.assert_array_equal(got[k], u32(want[k]), err_msg=k)
    spans_of = {g_: set(s) for g_, s in atomic.items()}
    if case == "group over several spans":
        assert any(len(s) >= 3 for s in spans_of.values())
    if case == "group starts on a span's last row":
        # the group starting on row span - 1 is its span's last and the next
        # span's first: two atomic commits
        gid = int(np.cumsum(active & ~adj)[span - 1]) - 1
        assert spans_of.get(gid) == {0, span}
    if case == "every row its own group" and n > 2 * span:
        assert len(stored) > 0 and all(len(s) == 1 for s in spans_of.values())
    if case == "all inactive":
        assert gn == 0 and not stored and not atomic
