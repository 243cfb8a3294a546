"""The port's forms past its kernels' shared-memory limits, against the JAX
package, bit for bit.

Each of K19 (k past ``TOPK_MAX_K``), K20 (candidates past
``HOT_MAX_CANDIDATES`` a side), K21 (a hot list past ``IN_SET_MAX_HOT``),
K22 (splitters past ``RANGE_SPLITTER_BYTES``), K9 (cells past
``MAX_STAGE_BINS - 1``, probes past ``MAX_BOUNDARY_BINS - 1``) and K10
(build rows past ``MAX_TABLE_BUILD``) takes another form past its limit,
chosen by plan code from the limit constant alone, so the CPU (whose plain
versions take any size) runs the card's path.  At the real limits where the
CPU reaches them: ``local_topk_hashes`` at k = 1025 and 4096 (with fewer
runs than k too), ``in_hash_set`` with a list of 65,536 entries, K22's
destinations with 14,530 splitters of 4 words (and 58,113 of one),
``value_boundaries`` over 60,002 probes and ``stage_to_cells`` over 40,000
cells.  With each constant shrunk through ``monkeypatch``: the skew
``make_dist_pipeline`` and ``dist_hash_join_skew``, ``shuffle`` and
``_dest_ranks``, ``dist_sort``, the overlapped join and
``member_multiplicity``.  A spy checks that each lifted form ran.  JAX runs
on its forced CPU devices; inputs come from numpy with a seed.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.kernels import (cells_plan, dist_plan, hot_set,
                                                               member_mult, range_dest,
                                                               stage_cells, topk_runs)
from database_technology_algorithms_tpu_torch.models import pipeline as tpipe
from database_technology_algorithms_tpu_torch.ops import hash_join as thash_join
from database_technology_algorithms_tpu_torch.parallel import dist_ops as tdist
from database_technology_algorithms_tpu_torch.parallel import overlap as toverlap
from database_technology_algorithms_tpu_torch.parallel import shuffle as tshuffle
from database_technology_algorithms_tpu_torch.parallel import skew as tskew
from test_torch_dist_pipeline import jax_run, pair, same_run
from test_torch_operators import assert_same_batch
from test_torch_overlap import jax_overlapped
from test_torch_parallel import (jax_op, jax_shuffle, jax_skew, meshes, same_table, t32,
                                 table_cols)

jmove = importlib.import_module("database_technology_algorithms_tpu.ops.movement")
jhash_join = importlib.import_module("database_technology_algorithms_tpu.ops.hash_join")
jshuffle = importlib.import_module("database_technology_algorithms_tpu.parallel.shuffle")
jskew = importlib.import_module("database_technology_algorithms_tpu.parallel.skew")
jdist = importlib.import_module("database_technology_algorithms_tpu.parallel.dist_ops")

M32 = 0xFFFFFFFF


def spy(monkeypatch, module, name: str) -> list:
    """Count the calls of ``module.name`` (a list that grows by one a call)."""
    calls, real = [], getattr(module, name)

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


# ---------------------------------------------------------------------------
# at the real limits


def topk_hashes(case: str, n: int, g) -> tuple[np.ndarray, np.ndarray]:
    if case == "zipf":
        h = (g.zipf(1.1, n) * 2654435761 % 2**32).astype(np.uint32)
    elif case == "few runs":  # fewer runs than k: the zero-count positions fill
        h = g.choice(np.array([3, 2**31 + 5, M32, 9, 77], np.uint32), n)
    else:
        h = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    active = g.random(n) < 0.8
    if case == "all dead":
        active[:] = False
    return h, active


@pytest.mark.parametrize("k,case", [(1025, "zipf"), (4096, "zipf"), (1025, "few runs"),
                                    (4096, "few runs"), (4096, "distinct"), (1025, "all dead"),
                                    (7000, "zipf")])
def test_local_topk_hashes_past_k19_matches_jax(k, case, monkeypatch):
    """k past K19's 1024 picks: the sort of the runs gives lax.top_k's
    arrays, the zero-count positions lowest first where k passes the runs
    (k = 7000 passes the rows too: clamped)."""
    g = np.random.default_rng(k + len(case))
    h, active = topk_hashes(case, 6000, g)
    calls = spy(monkeypatch, topk_runs, "topk_runs_sorted")
    wh, wc = jskew.local_topk_hashes(jnp.asarray(h), jnp.asarray(active), k)
    gh, gc = tskew.local_topk_hashes(t32(h), torch.from_numpy(active), k)
    np.testing.assert_array_equal(torch_to_u32(gh), np.asarray(wh))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    assert calls == [1] and k > dist_plan.TOPK_MAX_K


@pytest.mark.parametrize("hot_share", [0.0, 0.3])
def test_in_hash_set_past_k21_matches_jax(hot_share, monkeypatch):
    """A hot list of 65,536 entries (hh_topk 1024 on 32 shards, both sides),
    past K21's 58,108: its live entries sorted and searched."""
    g = np.random.default_rng(int(hot_share * 10) + 5)
    h = g.integers(0, 2**32, size=1500, dtype=np.uint64).astype(np.uint32)
    hot = np.full(65536, M32, np.uint32)
    live = g.choice(65536, 20000, replace=False)
    hot[live] = g.integers(0, 2**32, size=20000, dtype=np.uint64).astype(np.uint32)
    if hot_share:
        hot[live[:300]] = g.choice(h, 300)
        h[g.random(1500) < 0.1] = M32  # a sentinel hash never matches
    calls = spy(monkeypatch, hot_set, "in_hot_set_sorted")
    want = jskew.in_hash_set(jnp.asarray(h), jnp.asarray(hot))
    got = tskew.in_hash_set(t32(h), t32(hot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == [1] and 65536 > dist_plan.IN_SET_MAX_HOT
    assert bool(got.any()) == bool(hot_share)


@pytest.mark.parametrize("nw,ns", [(4, 14530), (1, 58113), (3, 20000)])
def test_range_dest_past_k22_matches_jax(nw, ns):
    """Splitters past K22's 232,448 bytes: in rounds, whose destinations add
    up to JAX's sum of ``_lex_ge`` (``dist_sort`` on 14,530 shards at 4 key
    words)."""
    g = np.random.default_rng(ns)
    words = [g.integers(0, 2**32, size=1200, dtype=np.uint64).astype(np.uint32)
             for _ in range(nw)]
    spl = np.sort(g.integers(0, 2**32, size=(ns, nw), dtype=np.uint64).astype(np.uint32), 0)
    words[0][:100] = spl[g.integers(0, ns, 100), 0]  # ties on the first word
    want = jnp.sum(jdist._lex_ge([jnp.asarray(w) for w in words],
                                 [jnp.asarray(spl[:, j]) for j in range(nw)]), axis=1,
                   dtype=jnp.int32)
    assert dist_plan.range_round(nw, ns) < ns
    got = range_dest.range_dest([t32(w) for w in words], [t32(spl[:, j]) for j in range(nw)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_value_boundaries_past_k9_probes_matches_jax():
    """60,002 probes (the shuffle's ndev + 2 at 60,000 shards), past K9's
    58,111: counted in rounds of probes."""
    g = np.random.default_rng(60002)
    d = g.integers(0, 70000, size=5000).astype(np.uint32)
    d[:50] = M32
    assert cells_plan.boundary_width(5000, 60002) < 60002
    want = jmove.value_boundaries(jnp.asarray(d), 60002)
    got = stage_cells.value_boundaries(t32(d), 60002)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("row_map", ["slots", "si", "none"])
def test_stage_to_cells_past_k9_cells_matches_jax(row_map, monkeypatch):
    """40,000 cells (the shuffle's pack at 40,000 shards), past K9's 38,399:
    two rounds; every output of JAX's stage_to_cells."""
    g = np.random.default_rng(len(row_map))
    n, nparts, cap = 3000, 40000, 2
    dest = g.integers(0, nparts + 3, size=n).astype(np.uint32)
    dest[:400] = g.integers(38000, 39000, size=400)  # the first round's last cells overflow
    active = g.random(n) < 0.9
    pay = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32) for _ in range(2)]
    calls = spy(monkeypatch, stage_cells, "_stage_rounds")
    wc, wn, wm, wo = jmove.stage_to_cells(jnp.asarray(dest), jnp.asarray(active), nparts, cap,
                                          [jnp.asarray(p) for p in pay], row_map=row_map)
    gc, gn, gm, go = stage_cells.stage_to_cells(t32(dest), torch.from_numpy(active), nparts, cap,
                                                [t32(p) for p in pay], row_map=row_map)
    for a, b in zip(gc, wc):
        np.testing.assert_array_equal(torch_to_u32(a), u32(b))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    assert int(go) == int(wo) > 0
    if row_map != "none":
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert calls == [1]


# ---------------------------------------------------------------------------
# the limits shrunk, through the public paths


SKEW_LIMITS = {"k19": {"TOPK_MAX_K": 8}, "k20": {"HOT_MAX_CANDIDATES": 20},
               "k21": {"IN_SET_MAX_HOT": 40},
               "all": {"TOPK_MAX_K": 8, "HOT_MAX_CANDIDATES": 20, "IN_SET_MAX_HOT": 40}}
SKEW_FORMS = {"TOPK_MAX_K": (topk_runs, "topk_runs_sorted"),
              "HOT_MAX_CANDIDATES": (hot_set, "hot_hashes_sorted"),
              "IN_SET_MAX_HOT": (hot_set, "in_hot_set_sorted")}


def shrink(monkeypatch, module, limits: dict) -> dict:
    """Set the module's limit constants; spy on the forms they select."""
    counts = {}
    for name, value in limits.items():
        monkeypatch.setattr(module, name, value)
        if name in SKEW_FORMS:
            counts[name] = spy(monkeypatch, *SKEW_FORMS[name])
    return counts


@pytest.mark.parametrize("kind,field,which", [(8, 1, "all"), (4, 1, "k19"), (4, 1, "k20"),
                                              (4, 1, "k21"), (3, 0, "all"), (3, 2, "all"),
                                              ("2x4", 1, "all")])
def test_skew_pipeline_past_the_limits_matches_jax(kind, field, which, monkeypatch):
    """``make_dist_pipeline`` with the skew engine (hh_topk 16: 16 picks, ndev
    * 16 candidates a side, a list of 2 * ndev * 16) under shrunk K19, K20
    and K21 limits equals JAX's run."""
    counts = shrink(monkeypatch, dist_plan, SKEW_LIMITS[which])
    want = jax_run(kind, field, "skew", 1, "tables")
    _, tm = meshes(kind)
    r, s = pair(kind, "tables")
    t1, t2 = tdist.distribute(tm, r), tdist.distribute(tm, s)
    cfg = TConfig(shuffle_slack=4.0, dist_join_engine="skew", shuffle_nchunks=1)
    got = tpipe.make_dist_pipeline(tm, field, cfg)(t1.batches, t1.counts, t2.batches, t2.counts)
    same_run(got, want)
    assert all(c for c in counts.values()), counts


@pytest.mark.parametrize("kind,case", [(8, "zipf probe"), (3, "hot build"), ("2x4", "zipf probe")])
def test_skew_join_past_the_limits_matches_jax(kind, case, monkeypatch):
    """``dist_hash_join_skew`` (hh_topk 8) on skewed tables with every K19,
    K20 and K21 limit shrunk: the hot list still finds the hot key."""
    counts = shrink(monkeypatch, dist_plan, {"TOPK_MAX_K": 4, "HOT_MAX_CANDIDATES": 10,
                                             "IN_SET_MAX_HOT": 20})
    build, probe, jcfg, (wt, wn, wovf, whot) = jax_skew(kind, 1, case)
    _, tm = meshes(kind)
    cfg = TConfig(shuffle_slack=jcfg.shuffle_slack, hh_factor=4, hh_topk=8)
    got, n, ovf, n_hot = tskew.dist_hash_join_skew(tm, tdist.distribute(tm, build),
                                                    tdist.distribute(tm, probe), 1, cfg)
    same_table(got, wt)
    assert (int(n), int(ovf), int(n_hot)) == (int(wn), int(wovf), int(whot))
    assert int(n_hot) >= 1 and all(c for c in counts.values()), counts


@pytest.mark.parametrize("kind,nchunks,cap,bins", [(8, 1, 120, 4), (8, 3, 120, 2), (3, 1, 90, 3),
                                                   ("2x4", 4, 120, 5), (4, 1, 40, 2)])
def test_shuffle_in_rounds_matches_jax(kind, nchunks, cap, bins, monkeypatch):
    """The shuffle's K9 pack over more shards than a round stages
    (``MAX_STAGE_BINS`` shrunk to `bins`: rounds of bins - 1 cells): the
    received rows, riders, totals and overflow equal JAX's."""
    monkeypatch.setattr(cells_plan, "MAX_STAGE_BINS", bins)
    calls = spy(monkeypatch, stage_cells, "_stage_rounds")
    cols, (out, ox0, ox1, total, _, ovf, _) = jax_shuffle(kind, nchunks, cap, 5)
    _, tm = meshes(kind)
    ndev = len(tm.devices)
    tt = tdist.distribute(tm, cols)
    dests = [tdist.hash_dest(b, 1, ndev) for b in tt.batches]
    extras = [(b.num ^ (0x9E3779B9 - (1 << 32)), b.recid) for b in tt.batches]
    got, gx, gtot, govf = tshuffle.shuffle_with_extra(tm, tt.batches, tt.counts, dests, cap,
                                                      TConfig(), extras=extras, nchunks=nchunks)
    assert_same_batch(TBatch.concat(got), out)
    for j, w in enumerate((ox0, ox1)):
        np.testing.assert_array_equal(torch_to_u32(torch.cat([x[j] for x in gx])), np.asarray(w))
    np.testing.assert_array_equal(torch.stack(gtot).numpy(), np.asarray(total))
    assert [int(o) for o in govf] == [int(ovf)] * ndev
    assert len(calls) == ndev


@pytest.mark.parametrize("ndev", [3, 17, 64])
def test_dest_ranks_in_rounds_matches_jax(ndev, monkeypatch):
    """``_dest_ranks`` with K9's cells and probes shrunk: the starts from
    rounds of probes, the "si" order from one K5 sort."""
    monkeypatch.setattr(cells_plan, "MAX_STAGE_BINS", 3)
    monkeypatch.setattr(cells_plan, "MAX_BOUNDARY_BINS", 4)
    calls = spy(monkeypatch, stage_cells, "_stage_rounds")
    g = np.random.default_rng(ndev)
    dest = g.integers(0, ndev + 1, size=2000).astype(np.int32)
    gc, gr = tshuffle._dest_ranks(torch.from_numpy(dest), ndev)
    for engine in ("onehot", "sort"):
        c, r = jshuffle._dest_ranks(jnp.asarray(dest), ndev, engine=engine)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(c))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(r))
    assert calls == [1]


@pytest.mark.parametrize("kind,field,limits", [
    (8, 1, {"RANGE_SPLITTER_BYTES": 8}), (3, 3, {"RANGE_SPLITTER_BYTES": 16}),
    (8, 2, {"RANGE_SPLITTER_BYTES": 12}), (4, 1, {"RANGE_SPLITTER_BYTES": 4})])
def test_dist_sort_past_the_limits_matches_jax(kind, field, limits, monkeypatch):
    """``dist_sort`` with K22's splitter bytes shrunk (one splitter a round
    at the smallest) and K9's cells shrunk: the shards equal JAX's."""
    for name, value in limits.items():
        monkeypatch.setattr(dist_plan, name, value)
    monkeypatch.setattr(cells_plan, "MAX_STAGE_BINS", 3)
    calls = spy(monkeypatch, range_dest, "range_dest")
    cols, (wt, wovf), _ = jax_op("sort", kind, field, 41)
    _, tm = meshes(kind)
    got, ovf = tdist.dist_sort(tm, tdist.distribute(tm, cols), field, TConfig(shuffle_slack=4.0))
    same_table(got, wt)
    assert int(ovf) == int(wovf) == 0
    assert len(calls) > len(tm.devices)  # the rounds' own calls beside one a shard


@pytest.mark.parametrize("kind,field,case,nchunks", [(8, 2, "short strings", 1),
                                                     (3, 3, "short strings", 2),
                                                     (8, 1, "hot", 4), (4, 0, "tables", 1)])
def test_overlapped_join_past_the_limits_matches_jax(kind, field, case, nchunks, monkeypatch):
    """The overlapped join with K10's build rows a pair shrunk (fields 2 and
    3 count through ``member_multiplicity``: parts of 5 rows) and its K9
    pack in rounds of 2 cells."""
    monkeypatch.setattr(cells_plan, "MAX_TABLE_BUILD", 5)
    monkeypatch.setattr(cells_plan, "MAX_STAGE_BINS", 3)
    build, probe, jcfg, (wt, wn, wovf), _ = jax_overlapped(kind, field, case, nchunks)
    _, tm = meshes(kind)
    got, n, ovf = toverlap.dist_hash_join_overlapped(
        tm, tdist.distribute(tm, build), tdist.distribute(tm, probe), field,
        TConfig(shuffle_slack=jcfg.shuffle_slack), nchunks=nchunks)
    same_table(got, wt)
    assert (int(n), int(ovf)) == (int(wn), int(wovf))


@pytest.mark.parametrize("nw,nb,part", [(1, 200, 7), (2, 333, 50), (3, 64, 1), (2, 90, 89)])
def test_member_multiplicity_in_parts_matches_jax(nw, nb, part, monkeypatch):
    """``member_multiplicity`` over more build rows than K10's table takes
    (``MAX_TABLE_BUILD`` shrunk to `part`): the parts' counts add up to
    JAX's, for one-word and multi-word keys, with duplicates across parts
    and dead query rows."""
    g = np.random.default_rng(nw * 1000 + nb)
    keys = g.integers(0, 12, size=(nb, nw)).astype(np.uint32)
    keys[:, 0] |= np.uint32(1 << 31) * (g.random(nb) < 0.3).astype(np.uint32)
    live_b = int(nb * 0.8)
    order = np.lexsort(keys.T[::-1])  # JAX's form wants the build keys sorted
    keys = keys[order]
    q = np.concatenate([keys[g.integers(0, nb, 150)],
                        g.integers(0, 12, size=(50, nw)).astype(np.uint32)])
    live_k = g.random(200) < 0.85
    want = jhash_join.member_multiplicity([jnp.asarray(keys[:, j]) for j in range(nw)],
                                          jnp.int32(live_b),
                                          [jnp.asarray(q[:, j]) for j in range(nw)],
                                          jnp.asarray(live_k))
    monkeypatch.setattr(cells_plan, "MAX_TABLE_BUILD", part)
    calls = spy(monkeypatch, member_mult, "member_multiplicity_cells_plain")
    got = thash_join.member_multiplicity([t32(keys[:, j]) for j in range(nw)], live_b,
                                         [t32(q[:, j]) for j in range(nw)],
                                         torch.from_numpy(live_k))
    np.testing.assert_array_equal(torch_to_u32(got), u32(want))
    assert len(calls) == -(-nb // part)


def test_tiled_join_k10_parts_match_jax(monkeypatch):
    """The tiled over-budget join with K10's build rows a pair shrunk below
    its cells' capacity: each step's pairs in parts, the counts equal
    JAX's."""
    cols_b, cols_p = table_cols(3, 71), table_cols(3, 72)
    from test_torch_operators import both_batches

    jb, tb = both_batches(cols_b)
    jp, tp = both_batches(cols_p)
    jcfg = importlib.import_module("database_technology_algorithms_tpu.config").EngineConfig(
        mem_rows=256)
    wm, wmult, wn = jhash_join.hash_join_count(jb, jp, 1, jcfg)
    monkeypatch.setattr(cells_plan, "MAX_TABLE_BUILD", 16)
    calls = spy(monkeypatch, member_mult, "member_multiplicity_cells_plain")
    gm, gmult, gn = thash_join.hash_join_count(tb, tp, 1, TConfig(mem_rows=256))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gmult.numpy(), np.asarray(wmult))
    assert int(gn) == int(wn) and len(calls) > 1


def test_the_plans_choose_from_the_constants():
    """Within a limit each plan keeps the kernel's one launch; past it, the
    other form; the constants are the card's."""
    assert (dist_plan.TOPK_MAX_K, dist_plan.HOT_MAX_CANDIDATES, dist_plan.IN_SET_MAX_HOT,
            dist_plan.RANGE_SPLITTER_BYTES, cells_plan.MAX_STAGE_BINS,
            cells_plan.MAX_BOUNDARY_BINS, cells_plan.MAX_TABLE_BUILD) == (
                1024, 29056, 58108, 232448, 38400, 58112, (1 << 30) - 1)
    assert not dist_plan.topk_by_sort(1024) and dist_plan.topk_by_sort(1025)
    assert not dist_plan.hot_by_sort(29056, 29056) and dist_plan.hot_by_sort(29057, 0)
    assert dist_plan.hot_by_sort(0, 29057)
    assert not dist_plan.in_set_by_sort(58108) and dist_plan.in_set_by_sort(58109)
    assert dist_plan.range_round(4, 14528) == 14528 and dist_plan.range_round(4, 14529) == 14528
    assert dist_plan.range_round(1, 58113) == 58112 and dist_plan.range_round(4, 0) == 1
    assert cells_plan.stage_width(1000, 38399) == 38399
    assert cells_plan.stage_width(1000, 38400) == 38399 == cells_plan.stage_width(10**6, 40000)
    # the count matrix: (W + 1) * spans(n) entries within 2^31 - 1
    n = (1 << 31) - 1
    assert (cells_plan.stage_width(n, 40000) + 1) * cells_plan.spans(n) <= cells_plan.MAX_ROWS
    assert cells_plan.boundary_width(1000, 58111) == 58111
    assert cells_plan.boundary_width(1000, 58112) == 58110
    assert cells_plan.table_part((1 << 30) - 1) == (1 << 30) - 1
    assert cells_plan.table_part((1 << 30) + 1) == (1 << 30) - 1
    for name, fn in (("check_topk", lambda: dist_plan.check_topk("t", 10, 11)),
                     ("check_hot_list", lambda: dist_plan.check_hot_list("t", 10, 58109))):
        with pytest.raises(ValueError):
            fn()
