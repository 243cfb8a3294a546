"""The port's chunked key-only distributed hash join
(``parallel/overlap.py``) against the JAX package, bit for bit.

``overlap_key_words``, ``_partition_words_to_slots`` (K9 with a 0xFFFFFFFF
fill), ``overlapped_join_local`` with and without ``colocated`` and
``dist_hash_join_overlapped`` (fields 0 and 1 by K15, fields 2 and 3 at a
stored width of 2 by K10), at 8, 4 and 3 shards and on the 2 x 4 host-chip
mesh, for 1-4 slices, with no match, and with a hot key whose overflow
forces the capacity retry.  JAX runs on its forced CPU devices, the port on
CPU shards (the kernels' plain versions); inputs come from numpy with a
seed; every comparison is exact.
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
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.metrics import OperatorStats as TStats
from database_technology_algorithms_tpu_torch.parallel import dist_ops as tdist
from database_technology_algorithms_tpu_torch.parallel import overlap as toverlap
from test_torch_operators import both_batches, make_cols
from test_torch_parallel import meshes, same_table, skewed, t32

jdist = importlib.import_module("database_technology_algorithms_tpu.parallel.dist_ops")
joverlap = importlib.import_module("database_technology_algorithms_tpu.parallel.overlap")

POOL = [b"", b"a", b"ab", b"Hola", b"hola", b"zzz", b"abcdefg", b"\xffz", b"\x80"]


@functools.lru_cache(maxsize=None)
def sides(kind, case: str):
    g = np.random.default_rng(len(case) + (kind if isinstance(kind, int) else 9))
    ndev = 8 if kind == "2x4" else kind
    if case == "no match":
        return M.random_cols(g, 40 * ndev, key_range=10**8), M.random_cols(g, 80 * ndev,
                                                                           key_range=10**8)
    if case == "hot":
        return skewed(400, 1, 7, 0.0), skewed(4000, 2, 7, 0.5)
    if case == "short strings":
        b = M.random_cols(g, 200 * ndev, key_range=50, str_pool=POOL)
        p = M.random_cols(g, 250 * ndev, key_range=50, str_pool=POOL)
        for c in (b, p):  # keys on both sides of 2^31
            c["num"] = np.where(g.random(len(c["num"])) < 0.4, c["num"] | np.uint32(1 << 31),
                                c["num"])
        return b, p
    return make_cols(250 * ndev - 11, seed=3), make_cols(300 * ndev - 29, seed=4)


def test_overlap_key_words_match_jax():
    for strings, words in (("short", 2), ("tie", 4)):
        jb, tb = both_batches(make_cols(50, 1, strings))
        assert tb.str_words == words
        for field in range(4):
            want = joverlap.overlap_key_words(jb, field)
            got = toverlap.overlap_key_words(tb, field)
            assert (got is None) == (want is None)
            for a, b in zip(got or [], want or []):
                np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))


@pytest.mark.parametrize("ndev,cap,nw", [(4, 64, 1), (3, 20, 2), (8, 9, 3), (1, 30, 1)])
def test_partition_words_to_slots_matches_jax(ndev, cap, nw):
    """Slots filled with 0xFFFFFFFF, each row's slot (ndev * cap for rows
    past the count or beyond capacity), counts and overflow."""
    g = np.random.default_rng(ndev * cap)
    n, count = 240, 200
    words = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32) for _ in range(nw)]
    dest = g.integers(0, ndev, size=n).astype(np.uint32)
    want = joverlap._partition_words_to_slots([jnp.asarray(w) for w in words], jnp.int32(count),
                                              jnp.asarray(dest), ndev, cap)
    got = toverlap._partition_words_to_slots([t32(w) for w in words], count, t32(dest), ndev,
                                             cap)
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[3]) == int(want[3])


@functools.lru_cache(maxsize=None)
def jax_overlapped(kind, field, case: str, nchunks: int):
    jm, _ = meshes(kind)
    build, probe = sides(kind, case)
    cfg = JConfig(shuffle_slack=1.5 if case == "hot" else 2.0)
    st = JStats()
    res = joverlap.dist_hash_join_overlapped(jm, jdist.distribute(jm, build),
                                             jdist.distribute(jm, probe), field, cfg,
                                             nchunks=nchunks, stats=st)
    return build, probe, cfg, res, st


OVERLAP_CASES = ([(8, f, "tables", c) for f in (0, 1) for c in (1, 3, 4)]
                 + [(k, 1, "tables", 2) for k in (4, 3, "2x4")]
                 + [(4, 0, "tables", 1), (3, 0, "tables", 4)]
                 + [(k, f, "short strings", c) for k in (8, 3) for f in (2, 3) for c in (1, 2)]
                 + [(4, 1, "no match", 4), (8, 1, "hot", 4), (3, 1, "hot", 2)])


@pytest.mark.parametrize("kind,field,case,nchunks", OVERLAP_CASES)
def test_dist_hash_join_overlapped_matches_jax(kind, field, case, nchunks):
    build, probe, jcfg, (wt, wn, wovf), wst = jax_overlapped(kind, field, case, nchunks)
    _, tm = meshes(kind)
    st = TStats()
    got, n, ovf = toverlap.dist_hash_join_overlapped(
        tm, tdist.distribute(tm, build), tdist.distribute(tm, probe), field,
        TConfig(shuffle_slack=jcfg.shuffle_slack), nchunks=nchunks, stats=st)
    same_table(got, wt)
    assert (int(n), int(ovf)) == (int(wn), int(wovf))
    assert int(n) == M.model_hash_join(build, probe, field)[2]
    g, w = dataclasses.asdict(st), dataclasses.asdict(wst)
    assert {k: v for k, v in g.items() if k != "wall_s"} == {k: v for k, v in w.items()
                                                           if k != "wall_s"}
    if case == "hot":
        assert st.retries > 0 and int(ovf) == 0


def test_overlapped_join_refuses_wide_strings():
    _, tm = meshes(4)
    cols = make_cols(200, 5, "tie")  # 4 stored string words
    t = tdist.distribute(tm, cols)
    with pytest.raises(AssertionError, match="short-word keys"):
        toverlap.dist_hash_join_overlapped(tm, t, t, 2)


@functools.lru_cache(maxsize=None)
def jax_colocated(kind, field, nchunks: int):
    """JAX's overlapped_join_local(colocated=True) inside shard_map."""
    jm, _ = meshes(kind)
    build, probe = sides(kind, "short strings")
    jb, jp = jdist.distribute(jm, build), jdist.distribute(jm, probe)
    ax = jm.axis_names if len(jm.axis_names) > 1 else jm.axis_names[0]
    row = P(jm.axis_names)
    ndev = len(jm.devices.flat)

    @functools.partial(shard_map, mesh=jm, in_specs=(row,) * 4,
                       out_specs=(row, row, P(), P()), check_vma=False)
    def body(bb, bc, pb, pc):
        out, cnt, nres, ovf = joverlap.overlapped_join_local(
            bb, bc[0], pb, pc[0], field, JConfig(), ndev, ax, 64, 64, 32, nchunks,
            colocated=True)
        return out, cnt[None].astype(jnp.int32), nres, ovf

    return build, probe, jax.jit(body)(jb.batch, jb.count, jp.batch, jp.count)


@pytest.mark.parametrize("kind,field,nchunks", [(8, 1, 2), (4, 0, 3), (3, 2, 2), (3, 3, 1),
                                                ("2x4", 3, 4)])
def test_overlapped_join_local_colocated_matches_jax(kind, field, nchunks):
    """The pipeline's form: no exchange, the same chunked probe against each
    shard's own build keys."""
    build, probe, (wout, wcnt, wn, wovf) = jax_colocated(kind, field, nchunks)
    _, tm = meshes(kind)
    tb, tp = tdist.distribute(tm, build), tdist.distribute(tm, probe)
    out, cnt, n, ovf = toverlap.overlapped_join_local(
        tm, tb.batches, tb.counts, tp.batches, tp.counts, field, TConfig(), 64, 64, 32, nchunks,
        colocated=True)
    same_table(tdist.DistTable(out, cnt), jdist.DistTable(wout, wcnt))
    assert [int(x) for x in n] == [int(wn)] * len(n)
    assert [int(x) for x in ovf] == [int(wovf)] * len(ovf) == [0] * len(ovf)
