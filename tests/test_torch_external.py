"""The PyTorch port's external (bounded-memory) drivers against the JAX
package's, on the same host chunks.

Each case streams the same numpy chunks (made from a seed) through the JAX
package's ``external_*`` on the CPU and the port's with ``device="cpu"``,
and requires the yielded chunks to be equal, column for column and chunk
for chunk, and every field of the port's ``OperatorStats`` but ``wall_s``
to be equal (the JAX fields it leaves out, those of the distributed plan,
must be 0): the tolerance is exact.  The cases are those of ``tests/test_external.py``
plus keys with bit 31 set (u32 order on the host), the all-equal-key path
and the distinct form at every field.
"""

import dataclasses

import numpy as np
import pytest

import model as M

from database_technology_algorithms_tpu import external as jext
from database_technology_algorithms_tpu.io import blockfile as jbf
from database_technology_algorithms_tpu.metrics import OperatorStats as JStats
from database_technology_algorithms_tpu_torch import external as text
from database_technology_algorithms_tpu_torch.io import blockfile as tbf
from database_technology_algorithms_tpu_torch.io.generator import generate_columns
from database_technology_algorithms_tpu_torch.metrics import OperatorStats as TStats

FIELDS = [0, 1, 2, 3]
# strings with bytes >= 0x80 (bit 31 of the first key word), shared prefixes,
# the empty string and strings past 8 bytes
POOL = [b"", b"a", b"ab", b"Hola", b"\xc3\xa9t\xc3\xa9", b"\xffz", b"\x80",
        b"prefix00A", b"prefix00B", b"longsharedprefix_x", b"zzz"]


def high_cols(seed: int, n: int, key_range: int, width: int = 128) -> dict:
    """Collision-heavy columns with bit 31 set in about half the recids and
    nums, and strings with high bytes."""
    g = np.random.default_rng(seed)
    cols = M.random_cols(g, n, key_range=key_range, str_pool=POOL, str_pad=width)
    for k in ("recid", "num"):
        cols[k] = np.where(g.random(n) < 0.5, cols[k] | np.uint32(1 << 31), cols[k])
    return cols


def chunks_of(cols: dict, size: int) -> list[dict]:
    n = len(cols["recid"])
    return [{k: v[i: i + size] for k, v in cols.items()} for i in range(0, n, size)]


def same_stats(tst: TStats, jst: JStats) -> None:
    """Every field of the port's stats but ``wall_s`` equals JAX's; the JAX
    fields the port leaves out (its distributed plan's) stay at 0."""
    t, j = dataclasses.asdict(tst), dataclasses.asdict(jst)
    t.pop("wall_s")
    assert t == {k: j[k] for k in t}
    assert not any(j[k] for k in set(j) - set(t) - {"wall_s"})


def spilled_files(root) -> list:
    return [p for p in root.rglob("*") if p.is_file()] if root.exists() else []


def both(fn: str, streams: list, field, tmp_path, **kw) -> tuple[dict, TStats]:
    """Run `fn` in both packages on the same chunk lists; assert equal
    chunks and stats and a clean spill directory; return the port's
    concatenated output and stats."""
    jst, tst = JStats(), TStats()
    jout = list(getattr(jext, fn)(*map(iter, streams), field, str(tmp_path / "jax"),
                                  stats=jst, **kw))
    tout = list(getattr(text, fn)(*map(iter, streams), field, str(tmp_path / "port"),
                                  stats=tst, device="cpu", **kw))
    assert [len(c["recid"]) for c in tout] == [len(c["recid"]) for c in jout]
    for jc, tc in zip(jout, tout):
        assert set(tc) == set(jc)
        for k in jc:
            assert tc[k].dtype == jc[k].dtype and tc[k].shape == jc[k].shape, k
            np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    same_stats(tst, jst)
    assert spilled_files(tmp_path / "port") == []
    merged = ({k: np.concatenate([c[k] for c in tout]) for k in tout[0]} if tout else
              {"recid": np.zeros(0, np.uint32), "num": np.zeros(0, np.uint32)})
    return merged, tst


@pytest.mark.parametrize("field", FIELDS)
def test_np_key_words_matches_jax(field):
    """The port's host key matrix equals the JAX package's device-derived
    one: u32, the full string width whatever width the chunk stores."""
    for width in (24, 128):
        cols = high_cols(3, 64, 20, width=width)
        want = jext._np_key_words(cols, field)
        got = text._np_key_words(cols, field)
        assert got.dtype == want.dtype == np.uint32
        assert got.shape == want.shape == (64, {0: 1, 1: 1, 2: 32, 3: 33}[field])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("field", FIELDS)
def test_external_sort_matches_jax(field, distinct, tmp_path):
    cols = high_cols(10 + field, 1000, key_range=150)
    out, st = both("external_sort", [chunks_of(cols, 256)], field, tmp_path,
                   mem_rows=256, distinct=distinct)
    assert st.nsorted_segs == 4 and st.npasses == 2 and 0 < st.peak_range_rows <= 256
    keys = M.all_keys(out, field)
    if distinct:
        assert keys == sorted(set(M.all_keys(cols, field)))
    else:
        assert keys == sorted(M.all_keys(cols, field))


@pytest.mark.parametrize("mem,field,n", [(30, 1, 300), (30, 2, 300), (700, 0, 2000),
                                         (700, 3, 2000)])
def test_external_sort_budgets_match_jax(mem, field, n, tmp_path):
    """Budgets of 30 and 700 rows: many small segments, or few large ones."""
    cols = high_cols(20 + mem, n, key_range=n // 4)
    _, st = both("external_sort", [chunks_of(cols, mem)], field, tmp_path, mem_rows=mem)
    assert st.nsorted_segs == -(-n // mem) and 0 < st.peak_range_rows <= mem


@pytest.mark.parametrize("nrows", [0, 400])
@pytest.mark.parametrize("distinct", [False, True])
def test_external_sort_single_chunk_matches_jax(distinct, nrows, tmp_path):
    """One chunk within the budget: a single pass, also for an empty input."""
    cols = {k: v[:nrows] for k, v in high_cols(4, 400, key_range=50).items()}
    out, st = both("external_sort", [[cols]], 2, tmp_path, mem_rows=1024, distinct=distinct)
    assert st.npasses == 1 and st.nsorted_segs == 1 and st.rows_out == len(out["recid"])


@pytest.mark.parametrize("distinct", [False, True])
def test_external_sort_splitter_miss_resplit_matches_jax(distinct, tmp_path, monkeypatch):
    """A hot key collapses adjacent splitters, so a pass-2 range holds the hot
    key and many distinct keys, far beyond the budget: the range is split
    again at its median (the JAX test's data)."""
    mem = 512
    num = np.concatenate([np.arange(50, dtype=np.uint32), np.full(1400, 100, np.uint32),
                          np.arange(200, 1200, dtype=np.uint32)])
    n = len(num)
    num = num[np.random.default_rng(7).permutation(n)] | np.uint32(1 << 31)
    cols = {"recid": np.arange(n, dtype=np.uint32), "num": num,
            "strs": np.zeros((n, 8), np.uint8), "valid": np.ones(n, bool)}
    seen = []
    real = text._searchsorted_rows
    monkeypatch.setattr(text, "_searchsorted_rows",
                        lambda m, s, side: (seen.append(side), real(m, s, side))[1])
    out, st = both("external_sort", [chunks_of(cols, mem)], 1, tmp_path, mem_rows=mem,
                   distinct=distinct)
    assert "left" in seen  # the median split of a mixed range ran
    assert 0 < st.peak_range_rows <= mem
    assert np.all(np.diff(out["num"].astype(np.int64)) >= 0)


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("field", [1, 3])
def test_external_sort_all_equal_keys_matches_jax(field, distinct, tmp_path):
    """Every key equal: the range cannot be split, so it streams in bounded
    sub-slices in row order; the distinct form cuts the key at the seams."""
    n = 1000
    cols = {"recid": np.arange(n, dtype=np.uint32) | np.uint32(1 << 31),
            "num": np.full(n, 0x80000007, np.uint32),
            "strs": np.zeros((n, 16), np.uint8), "valid": np.ones(n, bool)}
    cols["strs"][:, :3] = np.frombuffer(b"\xffab", np.uint8)
    out, st = both("external_sort", [chunks_of(cols, 128)], field, tmp_path, mem_rows=128,
                   distinct=distinct)
    assert st.peak_range_rows <= 128
    if distinct:
        assert out["recid"].tolist() == [int(cols["recid"][0])]
    else:
        np.testing.assert_array_equal(out["recid"], cols["recid"])


def test_external_sort_from_blockfile_sub_block_budget_matches_jax(tmp_path):
    """``blockfile_chunks`` yields the JAX package's chunks, also below one
    block's 100 rows, and the sort of them matches."""
    cols = generate_columns(5, seed=3)
    path = str(tmp_path / "small.bin")
    tbf.write_blockfile(path, cols)
    for mem in (30, 250):
        want = list(jext.blockfile_chunks(path, mem))
        got = list(text.blockfile_chunks(path, mem))
        assert len(got) == len(want) and all(len(c["recid"]) <= mem for c in got)
        for jc, tc in zip(want, got):
            for k in jc:
                np.testing.assert_array_equal(tc[k], jc[k])
    out, _ = both("external_sort", [list(text.blockfile_chunks(path, 30))], 1, tmp_path,
                  mem_rows=30)
    np.testing.assert_array_equal(np.sort(cols["num"]), out["num"])


def abandon(gen) -> None:
    """Take one output chunk and drop the generator mid-run."""
    next(gen)
    del gen


def test_external_sort_resume_matches_jax(tmp_path):
    """A run abandoned after pass 1 leaves its segments; a second run on the
    same spill directory reuses them (fewer device bytes) and equals JAX."""
    cols = high_cols(5, 1200, key_range=100)
    chunks = chunks_of(cols, 256)
    abandon(jext.external_sort(iter(chunks), 1, str(tmp_path / "jax"), mem_rows=256))
    abandon(text.external_sort(iter(chunks), 1, str(tmp_path / "port"), mem_rows=256,
                               device="cpu"))
    assert text.SegmentStore(str(tmp_path / "port")).manifest["segments"] == [0, 1, 2, 3, 4]
    _, st = both("external_sort", [chunks], 1, tmp_path, mem_rows=256)
    assert st.bytes_hbm == 2 * 1200 * (4 + 4 + 128 + 1)  # pass 2 only: pass 1 was resumed


def test_external_sort_stale_spill_dir_recomputes_like_jax(tmp_path):
    """Segments of another field, or of other data, are recomputed, never
    resumed."""
    cols = high_cols(6, 1000, key_range=80)
    cols2 = high_cols(7, 1000, key_range=80)
    for pkg, d, kw in ((jext, "jax", {}), (text, "port", {"device": "cpu"})):
        abandon(pkg.external_sort(iter(chunks_of(cols, 256)), 1, str(tmp_path / d),
                                  mem_rows=256, **kw))
    out, _ = both("external_sort", [chunks_of(cols, 256)], 2, tmp_path, mem_rows=256)
    assert M.all_keys(out, 2) == sorted(M.all_keys(cols, 2))
    for pkg, d, kw in ((jext, "jax", {}), (text, "port", {"device": "cpu"})):
        abandon(pkg.external_sort(iter(chunks_of(cols, 256)), 2, str(tmp_path / d),
                                  mem_rows=256, **kw))
    out, _ = both("external_sort", [chunks_of(cols2, 256)], 2, tmp_path, mem_rows=256)
    assert M.all_keys(out, 2) == sorted(M.all_keys(cols2, 2))


@pytest.mark.parametrize("field", FIELDS)
def test_external_merge_join_matches_jax(field, tmp_path):
    r = high_cols(30 + field, 900, key_range=200)
    s = high_cols(40 + field, 800, key_range=200)
    mem = 600
    out, st = both("external_merge_join", [chunks_of(r, mem // 2), chunks_of(s, mem // 2)],
                   field, tmp_path, mem_rows=mem)
    m_idx, m_nres = M.model_merge_join(r, s, field)
    assert st.nres == m_nres == len(out["recid"]) and 0 < st.peak_range_rows <= mem
    assert sorted(out["recid"].tolist()) == sorted(r["recid"][m_idx].tolist())
    assert (st.nunique_r, st.nunique_s) == (M.model_distinct(r, field)[1],
                                            M.model_distinct(s, field)[1])


@pytest.mark.parametrize("field", FIELDS)
def test_external_hash_join_matches_jax(field, tmp_path):
    """Field 3 keeps the build multiplicity (duplicated build rows)."""
    build = high_cols(50 + field, 700, key_range=150)
    build = {k: np.concatenate([v, v[:100]]) for k, v in build.items()}
    probe = high_cols(60 + field, 900, key_range=150)
    mem = 700
    out, st = both("external_hash_join",
                   [chunks_of(build, mem // 2), chunks_of(probe, mem // 2)],
                   field, tmp_path, mem_rows=mem)
    _, m_mult, m_nres = M.model_hash_join(build, probe, field)
    assert st.nres == m_nres and 0 < st.peak_range_rows <= mem
    want = np.repeat(probe["recid"], m_mult)
    assert sorted(out["recid"].tolist()) == sorted(want.tolist())


def test_external_hash_join_field3_key_spans_member_chunks_matches_jax(tmp_path):
    """One build key with more duplicates than the budget spans member
    chunks: the boundary carry hands its whole multiplicity on."""
    build = {"recid": np.arange(11, dtype=np.uint32), "num": np.array([5] * 10 + [7], np.uint32),
             "strs": np.zeros((11, 8), np.uint8), "valid": np.ones(11, bool)}
    probe = {"recid": np.arange(6, dtype=np.uint32) + 100,
             "num": np.array([5, 5, 5, 7, 7, 9], np.uint32),
             "strs": np.zeros((6, 8), np.uint8), "valid": np.ones(6, bool)}
    _, st = both("external_hash_join", [chunks_of(build, 4), chunks_of(probe, 4)], 3, tmp_path,
                 mem_rows=8)
    assert st.nres == 32  # 3 probe rows x 10 + 2 x 1


def test_external_join_member_stream_drained_matches_jax(tmp_path):
    """R runs out first: S's sort still finishes (its counters, its cleanup)."""
    r = high_cols(8, 400, key_range=100)
    r["num"] = (r["num"] % 50).astype(np.uint32)
    s = high_cols(9, 800, key_range=400)
    s["num"] = s["num"] & np.uint32(0x7FFFFFFF)
    _, st = both("external_merge_join", [chunks_of(r, 200), chunks_of(s, 200)], 1, tmp_path,
                 mem_rows=400)
    assert st.nunique_s == M.model_distinct(s, 1)[1]


def test_external_join_empty_chunk_guard_matches_jax(tmp_path):
    r = high_cols(11, 300, key_range=40)
    s = high_cols(12, 300, key_range=40)

    def with_empty(cols, size):
        return [{k: v[:0] for k, v in cols.items()}] + chunks_of(cols, size)

    _, st = both("external_merge_join", [with_empty(r, 150), with_empty(s, 150)], 1, tmp_path,
                 mem_rows=300)
    assert st.nres == M.model_merge_join(r, s, 1)[1]


def test_blockfile_writer_streaming_matches_jax(tmp_path):
    """Chunks of awkward sizes give the bytes of one ``write_blockfile`` of
    their concatenation, and of the JAX package's writer."""
    cols = high_cols(13, 1234, key_range=99)
    paths = {}
    for name, mod in (("jax", jbf), ("port", tbf)):
        paths[name] = tmp_path / f"{name}.bin"
        with mod.BlockFileWriter(str(paths[name])) as w:
            for size in (1, 99, 100, 101, 0, 500, 433):
                start = w.nrows
                w.append({k: v[start: start + size] for k, v in cols.items()})
        assert w.nrows == 1234 and w.blockid == 13
    tbf.write_blockfile(str(tmp_path / "whole.bin"), cols)
    assert paths["port"].read_bytes() == paths["jax"].read_bytes() == \
        (tmp_path / "whole.bin").read_bytes()
