"""The port's distributed layer against the JAX package, bit for bit: the
shard mesh and its collectives, the shuffle (``_dest_ranks``,
``partition_to_slots``, ``exchange``, ``shuffle``, ``shuffle_with_extra``),
the distributed operators (``dist_distinct``, ``dist_hash_join``,
``dist_aggregate``, ``dist_sort``) and the skew join (``local_topk_hashes``,
``hot_hash_set``, ``in_hash_set``, ``dist_hash_join_skew``).

JAX runs on its 8 forced CPU devices (``tests/conftest.py``) over meshes of
8, 4 and 3 of them and a 2 x 4 ("host", "chip") mesh; the port on a mesh of
as many shards on the CPU (each kernel's plain version).  Inputs come from
numpy with a seed.  Every value is an integer or a bool, so every
comparison is exact: each shard's rows (live and padding), each count, each
counter, overflow and retry.  Each JAX result is built once per module.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import model as M

from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu.metrics import OperatorStats as JStats
from database_technology_algorithms_tpu.ops.keys import key_hash as jkey_hash
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import as_u32, torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.metrics import OperatorStats as TStats
from database_technology_algorithms_tpu_torch.ops.keys import key_hash as tkey_hash
from database_technology_algorithms_tpu_torch.parallel import dist_ops as tdist
from database_technology_algorithms_tpu_torch.parallel import mesh as tmesh
from database_technology_algorithms_tpu_torch.parallel import shuffle as tshuffle
from database_technology_algorithms_tpu_torch.parallel import skew as tskew
from test_torch_operators import assert_same_batch, both_batches, make_cols

jpar = importlib.import_module("database_technology_algorithms_tpu.parallel")
jdist = importlib.import_module("database_technology_algorithms_tpu.parallel.dist_ops")
jshuffle = importlib.import_module("database_technology_algorithms_tpu.parallel.shuffle")
jskew = importlib.import_module("database_technology_algorithms_tpu.parallel.skew")

FIELDS = [0, 1, 2, 3]
MESHES = [8, 4, 3]
CPU = torch.device("cpu")


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


@functools.lru_cache(maxsize=None)
def meshes(kind):
    """(JAX mesh, port mesh): ``kind`` shards, or "2x4" hosts by chips."""
    if kind == "2x4":
        return (jpar.make_host_chip_mesh(n_hosts=2, chips_per_host=4),
                tmesh.make_host_chip_mesh(2, 4, devices="cpu"))
    return jpar.make_mesh(kind), tmesh.make_mesh(kind, devices="cpu")


@functools.lru_cache(maxsize=None)
def table_cols(kind, seed: int, strings: str = "tie", rows_per: int = 300) -> dict:
    """About `rows_per` rows a shard, the last shard short."""
    n = rows_per * tmesh.mesh_size(meshes(kind)[1]) - 37
    return make_cols(n, seed=seed, strings=strings)


def tables(kind, cols: dict):
    jm, tm = meshes(kind)
    return jdist.distribute(jm, cols), tdist.distribute(tm, cols)


def same_table(got, want) -> None:
    """Every shard's block and count, through the port's global view."""
    np.testing.assert_array_equal(got.global_count().numpy(),
                                  np.asarray(want.count).reshape(-1))
    assert_same_batch(got.global_batch(), want.batch)


def same_stats(got: TStats, want: JStats) -> None:
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    g.pop("wall_s"), w.pop("wall_s")
    assert g == w


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_shapes_and_devices():
    m = tmesh.make_mesh(3, devices="cpu")
    assert (m.axis_names, m.shape, tmesh.mesh_size(m)) == (("shard",), {"shard": 3}, 3)
    assert tmesh.SHARD_AXIS == "shard" and m.devices == (CPU,) * 3
    h = tmesh.make_host_chip_mesh(2, 4, devices="cpu")
    jm = jpar.make_host_chip_mesh(n_hosts=2, chips_per_host=4)
    assert h.axis_names == jm.axis_names and h.shape == dict(jm.shape)
    assert tmesh.mesh_size(h) == jpar.mesh_size(jm) == 8
    assert tmesh.make_mesh(devices=["cpu", "cpu"]).devices == (CPU, CPU)
    assert tmesh.mesh_size(tmesh.make_mesh(2, devices=["cpu"] * 5)) == 2
    with pytest.raises(ValueError, match="shards"):
        tmesh.Mesh((CPU,) * 3, ("host", "chip"), (2, 2))


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_mesh_collectives_match_jax(ndev):
    """all_to_all, all_gather and psum of the port's mesh against JAX's
    collectives inside shard_map, on int32 words and bools."""
    g = np.random.default_rng(ndev)
    x = g.integers(-2**31, 2**31, size=(ndev, ndev * 5), dtype=np.int64).astype(np.int32)
    b = g.random((ndev, ndev * 5)) < 0.5
    jm = jpar.make_mesh(ndev)
    tm = tmesh.make_mesh(ndev, devices="cpu")

    @functools.partial(shard_map, mesh=jm, in_specs=(P("shard"), P("shard")),
                       out_specs=(P("shard"), P("shard"), P("shard"), P("shard")),
                       check_vma=False)
    def body(xs, bs):
        return (jax.lax.all_to_all(xs, "shard", 0, 0, tiled=True),
                jax.lax.all_to_all(bs, "shard", 0, 0, tiled=True),
                jax.lax.all_gather(xs, "shard", tiled=True),
                jax.lax.psum(xs, "shard"))

    want = [np.asarray(w) for w in jax.jit(body)(jnp.asarray(x.reshape(-1)),
                                                 jnp.asarray(b.reshape(-1)))]
    xs = [torch.from_numpy(r.copy()) for r in x]
    bs = [torch.from_numpy(r.copy()) for r in b]
    got = [tm.all_to_all(xs), tm.all_to_all(bs), tm.all_gather(xs), tm.psum(xs)]
    for gw, ww in zip(got, want):
        np.testing.assert_array_equal(torch.cat(gw).numpy(), ww)
    with pytest.raises(ValueError, match="one tensor a shard"):
        tm.psum(xs[:-1] if ndev > 1 else xs * 2)


def test_mesh_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_host_chip_mesh(2, 2)


def test_operator_stats_match_jax():
    """The port's OperatorStats has the JAX fields (the shuffle's bytes_ici,
    bytes_dcn and retries included) and merges as JAX does."""
    assert [f.name for f in dataclasses.fields(TStats)] == [
        f.name for f in dataclasses.fields(JStats)]
    vals = {f.name: i + 3 for i, f in enumerate(dataclasses.fields(JStats)) if f.name != "op"}
    got = TStats(op="a", **vals).merge(TStats(op="b", **vals))
    want = JStats(op="a", **vals).merge(JStats(op="b", **vals))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the shuffle


@pytest.mark.parametrize("ndev", [1, 3, 6, 8, 17, 64])
def test_dest_ranks_match_jax(ndev):
    """Both JAX engines and the port's (one K9 form for every name) agree,
    the drop destination ndev included."""
    g = np.random.default_rng(ndev)
    dest = g.integers(0, ndev + 1, size=2000).astype(np.int32)
    got = [tshuffle._dest_ranks(torch.from_numpy(dest), ndev, e)
           for e in ("auto", "onehot", "sort")]
    for engine in ("onehot", "sort"):
        c, r = jshuffle._dest_ranks(jnp.asarray(dest), ndev, engine=engine)
        for gc, gr in got:
            np.testing.assert_array_equal(gc.numpy(), np.asarray(c))
            np.testing.assert_array_equal(gr.numpy(), np.asarray(r))
    with pytest.raises(ValueError, match="unknown rank engine"):
        tshuffle._dest_ranks(torch.from_numpy(dest), ndev, "nosuch")
    empty = tshuffle._dest_ranks(torch.zeros(0, dtype=torch.int32), ndev, "nosuch")
    assert empty[0].tolist() == [0] * (ndev + 1) and empty[1].numel() == 0


@pytest.mark.parametrize("route", ["gather", "sort"])
@pytest.mark.parametrize("ndev,cap,count", [(4, 64, 300), (3, 40, 250), (6, 7, 180),
                                            (8, 16, 0)])
def test_partition_to_slots_matches_jax(ndev, cap, count, route):
    """Slots, riders, counts clamped to cap, overflow and zeroed dead slots
    equal both JAX routes (the JAX placement sort and the scatter)."""
    cols = make_cols(300, seed=ndev * 10 + cap)
    jb, tb = both_batches(cols)
    g = np.random.default_rng(cap)
    dest = g.integers(0, ndev, size=300).astype(np.uint32)
    extra = [g.integers(0, 2**32, size=300, dtype=np.uint64).astype(np.uint32)
             for _ in range(2)]
    want = jshuffle.partition_to_slots(jb, jnp.int32(count), jnp.asarray(dest), ndev, cap,
                                       JConfig(materialize=route),
                                       extra=tuple(jnp.asarray(e) for e in extra))
    got = tshuffle.partition_to_slots(tb, count, t32(dest), ndev, cap,
                                      TConfig(materialize=route),
                                      extra=tuple(t32(e) for e in extra))
    assert_same_batch(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(torch_to_u32(a), np.asarray(b))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])


@functools.lru_cache(maxsize=None)
def jax_shuffle(kind, nchunks: int, cap: int, seed: int):
    """JAX's shuffle_with_extra (and its exchange's received counts) inside
    shard_map, on table_cols(kind, seed) with hash destinations and two
    rider words."""
    jm, _ = meshes(kind)
    ndev = jpar.mesh_size(jm)
    cols = table_cols(kind, seed)
    jt = jdist.distribute(jm, cols)
    ax = jm.axis_names if len(jm.axis_names) > 1 else jm.axis_names[0]
    row = P(jm.axis_names)
    cfg = JConfig()

    @functools.partial(shard_map, mesh=jm, in_specs=(row, row), check_vma=False,
                       out_specs=(row, row, row, row, row, P(), row))
    def body(batch, count):
        count = count[0]
        dest = jkey_hash(batch, 1) % jnp.uint32(ndev)
        extra = (batch.num ^ jnp.uint32(0x9E3779B9), batch.recid)
        out, ox, total, ovf = jshuffle.shuffle_with_extra(
            batch, count, dest, ax, ndev, cap, cfg, extra=extra, nchunks=nchunks)
        send, sx, counts, _ = jshuffle.partition_to_slots(batch, count, dest, ndev, cap, cfg,
                                                          extra=extra)
        _, _, _, recv_counts = jshuffle.exchange(send, counts, ax, cap, cfg, extra=sx)
        return out, ox[0], ox[1], total[None], recv_counts, ovf, count[None]

    return cols, jax.jit(body)(jt.batch, jt.count)


@pytest.mark.parametrize("kind,nchunks,cap", [(8, 1, 120), (8, 3, 120), (4, 1, 40),
                                              (3, 2, 200), (3, 1, 90), ("2x4", 4, 120)])
def test_shuffle_matches_jax(kind, nchunks, cap):
    """shuffle_with_extra, shuffle and exchange over the mesh: received rows
    and riders, totals, per-source counts and the summed overflow (the small
    caps overflow)."""
    cols, (out, ox0, ox1, total, recv_counts, ovf, _) = jax_shuffle(kind, nchunks, cap, 5)
    _, tm = meshes(kind)
    ndev = tmesh.mesh_size(tm)
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
    if nchunks == 1:
        plain, ptot, povf = tshuffle.shuffle(tm, tt.batches, tt.counts, dests, cap)
        assert_same_batch(TBatch.concat(plain), out)
        assert [int(t) for t in ptot] == [int(t) for t in gtot] and int(povf[0]) == int(ovf)
        packed = [tshuffle.partition_to_slots(b, c, d, ndev, cap)
                  for b, c, d in zip(tt.batches, tt.counts, dests)]
        ex = tshuffle.exchange(tm, [p[0] for p in packed], [p[2] for p in packed], cap)
        np.testing.assert_array_equal(torch.cat(ex[3]).numpy(), np.asarray(recv_counts))
        assert_same_batch(TBatch.concat(ex[0]), out)


@pytest.mark.parametrize("ndev", [3, 6, 7])
def test_hash_dest_takes_the_u32_modulo(ndev):
    """The destination of a hash with bit 31 set is its u32 value's residue
    (torch's % of the negative int32 would take the divisor's sign), equal to
    JAX's key_hash % uint32(ndev)."""
    cols = make_cols(500, seed=ndev)
    jb, tb = both_batches(cols)
    for field in FIELDS:
        h = tkey_hash(tb, field)
        assert bool((h < 0).any())
        want = np.asarray(jkey_hash(jb, field) % jnp.uint32(ndev))
        got = tdist.hash_dest(tb, field, ndev)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
        assert not np.array_equal((h % ndev).numpy(), want)


# ---------------------------------------------------------------------------
# the distributed operators


@functools.lru_cache(maxsize=None)
def jax_op(op: str, kind, field, seed: int, slack: float = 4.0, strings: str = "tie"):
    jm, _ = meshes(kind)
    cfg = JConfig(shuffle_slack=slack)
    st = JStats()
    cols = table_cols(kind, seed, strings)
    jt = jdist.distribute(jm, cols)
    if op == "distinct":
        return cols, jdist.dist_distinct(jm, jt, field, cfg, stats=st), st
    if op == "aggregate":
        return cols, jdist.dist_aggregate(jm, jt, field, cfg, stats=st), st
    if op == "sort":
        return cols, jdist.dist_sort(jm, jt, field, cfg, stats=st), st
    probe = table_cols(kind, seed + 1, strings)
    jp = jdist.distribute(jm, probe)
    return (cols, probe), jdist.dist_hash_join(jm, jt, jp, field, cfg, stats=st), st


def op_cases(full: int) -> list:
    """Every field on the mesh of `full` shards, fields 1 and 2 on the other
    two meshes, field 1 on the host-chip mesh."""
    return ([(full, f) for f in FIELDS] + [(k, f) for k in MESHES if k != full for f in (1, 2)]
            + [("2x4", 1)])


@pytest.mark.parametrize("kind,field", op_cases(8))
def test_dist_distinct_matches_jax(kind, field):
    cols, (wt, wn, wovf), wst = jax_op("distinct", kind, field, 11)
    _, tm = meshes(kind)
    st = TStats()
    got, n, ovf = tdist.dist_distinct(tm, tdist.distribute(tm, cols), field,
                                      TConfig(shuffle_slack=4.0), stats=st)
    same_table(got, wt)
    assert (int(n), int(ovf)) == (int(wn), int(wovf)) and int(n) > 0
    same_stats(st, wst)


@pytest.mark.parametrize("kind,field", op_cases(4))
def test_dist_hash_join_matches_jax(kind, field):
    (b, p), (wt, wn, wovf), wst = jax_op("join", kind, field, 21)
    _, tm = meshes(kind)
    st = TStats()
    got, n, ovf = tdist.dist_hash_join(tm, tdist.distribute(tm, b), tdist.distribute(tm, p),
                                       field, TConfig(shuffle_slack=4.0), stats=st)
    same_table(got, wt)
    assert (int(n), int(ovf)) == (int(wn), int(wovf)) and int(n) > 0
    same_stats(st, wst)


@pytest.mark.parametrize("kind,field", op_cases(3))
def test_dist_aggregate_matches_jax(kind, field):
    cols, (wt, waggs, wovf), wst = jax_op("aggregate", kind, field, 31)
    _, tm = meshes(kind)
    st = TStats()
    got, aggs, ovf = tdist.dist_aggregate(tm, tdist.distribute(tm, cols), field,
                                          TConfig(shuffle_slack=4.0), stats=st)
    same_table(got, wt)
    for k in ("count", "sum", "min", "max"):
        np.testing.assert_array_equal(torch_to_u32(torch.cat([a[k] for a in aggs])),
                                      np.asarray(waggs[k]).astype(np.uint32))
    assert int(ovf) == int(wovf)
    same_stats(st, wst)


@pytest.mark.parametrize("kind,field", op_cases(8) + [(3, 3), (8, "short 2"), (4, "short 3")])
def test_dist_sort_matches_jax(kind, field):
    strings = "tie"
    if isinstance(field, str):  # 2-word strings: the splitters hold whole keys
        strings, field = "short", int(field[-1])
    cols, (wt, wovf), wst = jax_op("sort", kind, field, 41, strings=strings)
    _, tm = meshes(kind)
    st = TStats()
    got, ovf = tdist.dist_sort(tm, tdist.distribute(tm, cols), field,
                               TConfig(shuffle_slack=4.0), stats=st)
    same_table(got, wt)
    assert int(ovf) == int(wovf) == 0
    same_stats(st, wst)
    # the shards in mesh order are the sorted table
    keys = M.all_keys(tdist.collect(got), field)
    assert keys == sorted(keys) and len(keys) == len(cols["recid"])


def test_collect_matches_jax():
    cols = table_cols(3, 51)
    jt, tt = tables(3, cols)
    want, got = jdist.collect(jt), tdist.collect(tt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tt.rows_per_chip == jt.rows_per_chip
    same_table(tt, jt)


def skewed(n: int, seed: int, hot_key: int, hot_share: float, key_range: int = 50) -> dict:
    g = np.random.default_rng(seed)
    cols = M.random_cols(g, n, key_range=key_range)
    cols["num"] = np.where(g.random(n) < hot_share, hot_key, cols["num"]).astype(np.uint32)
    cols["num"] |= np.where(g.random(n) < 0.3, np.uint32(1 << 31), np.uint32(0))
    return cols


@functools.lru_cache(maxsize=None)
def jax_retry(kind):
    """A hot probe key under slack 1.5: the plain join overflows, retries and
    stays exact."""
    jm, _ = meshes(kind)
    build = skewed(400, 1, 7, 0.0)
    probe = skewed(4000, 2, 7, 0.5)
    cfg = JConfig(shuffle_slack=1.5, hh_factor=4, hh_topk=8)
    st = JStats()
    res = jdist.dist_hash_join(jm, jdist.distribute(jm, build), jdist.distribute(jm, probe), 1,
                               cfg, stats=st)
    skew = jskew.dist_hash_join_skew(jm, jdist.distribute(jm, build),
                                     jdist.distribute(jm, probe), 1, cfg)
    return build, probe, res, st, skew


@pytest.mark.parametrize("kind", [8, 3])
def test_overflow_retry_matches_jax(kind):
    build, probe, (wt, wn, wovf), wst, _ = jax_retry(kind)
    _, tm = meshes(kind)
    st = TStats()
    cfg = TConfig(shuffle_slack=1.5, hh_factor=4, hh_topk=8)
    got, n, ovf = tdist.dist_hash_join(tm, tdist.distribute(tm, build),
                                       tdist.distribute(tm, probe), 1, cfg, stats=st)
    assert wst.retries > 0 and st.retries == wst.retries
    same_table(got, wt)
    assert (int(n), int(ovf)) == (int(wn), int(wovf)) == (M.model_hash_join(build, probe, 1)[2], 0)
    same_stats(st, wst)


# ---------------------------------------------------------------------------
# skew


@pytest.mark.parametrize("case", ["zipf", "few runs", "all dead", "one run", "ties", "n < k"])
def test_local_topk_hashes_matches_jax(case):
    """The arrays themselves, not only the hot set: lax.top_k's order, and
    with fewer than k runs the zero-count positions, lowest first."""
    g = np.random.default_rng(len(case))
    n, k = (5, 16) if case == "n < k" else (3000, 16)
    if case == "zipf":
        h = (g.zipf(1.3, n) * 2654435761 % 2**32).astype(np.uint32)
    elif case == "few runs":
        h = g.choice(np.array([3, 2**31 + 5, 0xFFFFFFFF, 9], np.uint32), n)
    elif case == "one run":
        h = np.full(n, 2**31 + 77, np.uint32)
    elif case == "ties":
        h = np.repeat(g.integers(0, 2**32, size=n // 10, dtype=np.uint64), 10)[:n]
        h = g.permutation(h).astype(np.uint32)
    else:
        h = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    active = g.random(n) < 0.8
    if case == "all dead":
        active[:] = False
    wh, wc = jskew.local_topk_hashes(jnp.asarray(h), jnp.asarray(active), k)
    gh, gc = tskew.local_topk_hashes(t32(h), torch.from_numpy(active), k)
    np.testing.assert_array_equal(torch_to_u32(gh), np.asarray(wh))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("hot_share", [0.0, 0.3])
def test_in_hash_set_matches_jax(hot_share):
    g = np.random.default_rng(int(hot_share * 10))
    h = g.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    hot = np.full(64, 0xFFFFFFFF, np.uint32)
    picks = g.choice(h, 10) if hot_share else np.zeros(0, np.uint32)
    hot[g.choice(64, len(picks), replace=False)] = picks
    h[g.random(1000) < hot_share] = 0xFFFFFFFF  # a sentinel hash never matches
    want = jskew.in_hash_set(jnp.asarray(h), jnp.asarray(hot))
    np.testing.assert_array_equal(tskew.in_hash_set(t32(h), t32(hot)).numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def jax_hot_set(kind, seed: int):
    """JAX's hot_hash_set inside shard_map on the probe side of skewed(...)."""
    jm, _ = meshes(kind)
    ndev = jpar.mesh_size(jm)
    cols = skewed(300 * ndev, seed, 7, 0.4, key_range=200)
    jt = jdist.distribute(jm, cols)
    ax = jm.axis_names if len(jm.axis_names) > 1 else jm.axis_names[0]
    row = P(jm.axis_names)

    @functools.partial(shard_map, mesh=jm, in_specs=(row, row), out_specs=row, check_vma=False)
    def body(batch, count):
        active = jnp.arange(batch.nrows) < count[0]
        thr = jnp.maximum(jax.lax.psum(count[0], ax) // (ndev * 4), 1).astype(jnp.int32)
        return jskew.hot_hash_set(key_hash_1(batch), active, ax, 16, thr)

    return cols, np.asarray(jax.jit(body)(jt.batch, jt.count))


def key_hash_1(batch):
    return jkey_hash(batch, 1)


@pytest.mark.parametrize("kind", [8, 4, 3, "2x4"])
def test_hot_hash_set_matches_jax(kind):
    cols, want = jax_hot_set(kind, 3)
    _, tm = meshes(kind)
    ndev = tmesh.mesh_size(tm)
    tt = tdist.distribute(tm, cols)
    active = [torch.arange(b.nrows) < c for b, c in zip(tt.batches, tt.counts)]
    thr = [(t // (ndev * 4)).clamp(min=1) for t in tm.psum(tt.counts)]
    got = tskew.hot_hash_set(tm, [tkey_hash(b, 1) for b in tt.batches], active, 16, thr)
    np.testing.assert_array_equal(torch_to_u32(torch.cat(got)), want)
    assert (want != 0xFFFFFFFF).any()


@functools.lru_cache(maxsize=None)
def jax_skew(kind, field, case: str):
    jm, _ = meshes(kind)
    ndev = jpar.mesh_size(jm)
    if case == "zipf probe":
        build, probe = skewed(400, 1, 7, 0.0), skewed(300 * ndev, 2, 7, 0.5)
    elif case == "hot build":
        build, probe = skewed(300 * ndev, 3, 9, 0.5), skewed(600, 4, 9, 0.0)
    else:
        build, probe = table_cols(kind, 61), table_cols(kind, 62)
    cfg = JConfig(shuffle_slack=1.5 if case != "uniform" else 4.0, hh_factor=4, hh_topk=8)
    res = jskew.dist_hash_join_skew(jm, jdist.distribute(jm, build),
                                    jdist.distribute(jm, probe), field, cfg)
    return build, probe, cfg, res


SKEW_CASES = ([(k, 1, "zipf probe") for k in ("2x4", 8, 4, 3)]
              + [(k, 1, "hot build") for k in (8, 3)]
              + [(k, f, "uniform") for k in (8, 3) for f in (0, 1, 2)])


@pytest.mark.parametrize("kind,field,case", SKEW_CASES)
def test_dist_hash_join_skew_matches_jax(kind, field, case):
    build, probe, jcfg, (wt, wn, wovf, whot) = jax_skew(kind, field, case)
    _, tm = meshes(kind)
    cfg = TConfig(shuffle_slack=jcfg.shuffle_slack, hh_factor=4, hh_topk=8)
    got, n, ovf, n_hot = tskew.dist_hash_join_skew(tm, tdist.distribute(tm, build),
                                                    tdist.distribute(tm, probe), field, cfg)
    same_table(got, wt)
    assert (int(n), int(ovf), int(n_hot)) == (int(wn), int(wovf), int(whot))
    assert int(n) == M.model_hash_join(build, probe, field)[2]
    if case != "uniform":
        assert int(n_hot) >= 1 and int(ovf) == 0
