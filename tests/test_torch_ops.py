"""The PyTorch port's kernels' functions against the JAX package, bit for bit.

Inputs are made from a seed with numpy and handed to both packages; JAX
runs on the CPU (conftest), the port on CPU tensors, i.e. each kernel's
plain torch version.  Every value is an integer or a bool, so every
comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu import batch as jbatch
from database_technology_algorithms_tpu.io import blockfile as jblock
from database_technology_algorithms_tpu.io import generator as jgen
from database_technology_algorithms_tpu.ops import movement as jmove
from database_technology_algorithms_tpu.ops import scan as jscan
from database_technology_algorithms_tpu.ops import sort as jsort
from database_technology_algorithms_tpu_torch import batch as tbatch
from database_technology_algorithms_tpu_torch.io import blockfile as tblock
from database_technology_algorithms_tpu_torch.io import generator as tgen
from database_technology_algorithms_tpu_torch.ops import filter as tfilter
from database_technology_algorithms_tpu_torch.ops import keys as tkeys
from database_technology_algorithms_tpu_torch.ops import movement as tmove
from database_technology_algorithms_tpu_torch.ops import scan as tscan
from database_technology_algorithms_tpu_torch.ops import sort as tsort

CPU = torch.device("cpu")


def t32(a) -> torch.Tensor:
    """numpy u32/i32 -> the port's int32 bit pattern."""
    return tbatch.u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


def u32(t: torch.Tensor) -> np.ndarray:
    return tbatch.torch_to_u32(t)


def full_range(g, n):
    """u32 values over the whole range, a fifth of them >= 2^31, some repeats."""
    v = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    v[g.random(n) < 0.2] |= np.uint32(1 << 31)
    v[g.random(n) < 0.3] = v[0]
    return v


# n on both sides of the JAX blocked-scan threshold (n <= 2*512, ops/scan.py:36)
SCAN_SIZES = [1, 37, 1024, 1025, 3001]


@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("fn", ["seg_carry", "seg_min", "seg_max", "cumsum"])
def test_scans_match_jax(fn, n):
    g = np.random.default_rng(n)
    vals = full_range(g, n)
    flags = g.random(n) < 0.2
    if fn == "cumsum":
        want = jax.jit(jscan.cumsum)(jnp.asarray(vals))
        got = tscan.cumsum(t32(vals))
    else:
        want = jax.jit(getattr(jscan, fn))(jnp.asarray(flags), jnp.asarray(vals))
        got = getattr(tscan, fn)(torch.from_numpy(flags), t32(vals))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("n", [5, 1500])
def test_signed_and_reversed_scans_match_jax(n):
    g = np.random.default_rng(7 + n)
    ivals = g.integers(-(2**31), 2**31, size=n, dtype=np.int64).astype(np.int32)
    flags = g.random(n) < 0.1
    jf, jv = jnp.asarray(flags), jnp.asarray(ivals)
    tf, tv = torch.from_numpy(flags), torch.from_numpy(ivals.copy())
    seg_min, seg_max = jax.jit(jscan.seg_min), jax.jit(jscan.seg_max)
    np.testing.assert_array_equal(
        tscan.seg_min(tf, tv, signed=True).numpy(), np.asarray(seg_min(jf, jv)))
    np.testing.assert_array_equal(
        tscan.seg_max(tf, tv, signed=True).numpy(), np.asarray(seg_max(jf, jv)))
    np.testing.assert_array_equal(
        tscan.cumsum(tv).numpy(), np.asarray(jax.jit(jscan.cumsum)(jv)))
    # the reversed form is stage A's any-S suffix (models/pipeline.py:292-295)
    uvals = full_range(g, n)
    want = jnp.flip(seg_max(jnp.flip(jf), jnp.flip(jnp.asarray(uvals))))
    got = tscan.seg_max(tf, t32(uvals), reverse=True)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 333, 5000])
@pytest.mark.parametrize("with_extra", [False, True])
def test_packed_view_sort_matches_jax(n, with_extra):
    g = np.random.default_rng(100 + n)
    key = full_range(g, n)
    inact = g.random(n) < 0.15
    extra = (full_range(g, n),) if with_extra else ()
    ws_key, wperm, wact, wex = jsort.packed_u32_view_sort(
        jnp.asarray(inact.astype(np.uint32)), jnp.asarray(key),
        tuple(jnp.asarray(e) for e in extra))
    for sort in (tsort.packed_u32_view_sort, tsort.view_sort_3key):
        s_key, perm, act, ex = sort(
            torch.from_numpy(inact), t32(key), tuple(t32(e) for e in extra))
        np.testing.assert_array_equal(u32(s_key), np.asarray(ws_key))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
        np.testing.assert_array_equal(act.numpy(), np.asarray(wact))
        for a, b in zip(ex, wex, strict=True):
            np.testing.assert_array_equal(u32(a), np.asarray(b))


def test_view_sort_all_inactive_matches_jax():
    g = np.random.default_rng(3)
    key = full_range(g, 700)
    inact = np.ones(700, bool)
    ws_key, wperm, wact, _ = jsort.packed_u32_view_sort(
        jnp.asarray(inact.astype(np.uint32)), jnp.asarray(key))
    s_key, perm, act, _ = tsort.packed_u32_view_sort(torch.from_numpy(inact), t32(key))
    np.testing.assert_array_equal(u32(s_key), np.asarray(ws_key))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(wperm))
    assert not act.any() and not np.asarray(wact).any()


@pytest.mark.parametrize("n", [1, 40, 2500])
def test_compact_words_matches_jax(n):
    g = np.random.default_rng(200 + n)
    keep = g.random(n) < 0.4
    words = [full_range(g, n), g.integers(-5, 5, size=n).astype(np.int32)]
    wcnt, wout = jmove.compact_words(jnp.asarray(keep), tuple(jnp.asarray(w) for w in words))
    cnt, out = tmove.compact_words(
        torch.from_numpy(keep), (t32(words[0]), torch.from_numpy(words[1].copy())))
    assert int(cnt) == int(wcnt)
    np.testing.assert_array_equal(u32(out[0]), np.asarray(wout[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(wout[1]))


@pytest.mark.parametrize("k", [2, 8])
def test_take_fill_matches_jax(k):
    g = np.random.default_rng(k)
    n, m = 300, 450
    cols = {
        "recid": full_range(g, n), "num": full_range(g, n),
        "strw": g.integers(0, 2**32, size=(n, k), dtype=np.uint64).astype(np.uint32),
        "valid": g.random(n) < 0.8,
    }
    # in range, negative (from the end), beyond either end: fill rows
    idx = g.integers(-n - 20, n + 20, size=m).astype(np.int32)
    jb = jbatch.RecordBatch(**{c: jnp.asarray(v) for c, v in cols.items()})
    tb = tbatch.RecordBatch.from_jax_arrays(
        cols["recid"], cols["num"], cols["strw"], cols["valid"], device="cpu")
    want = jb.take_fill(jnp.asarray(idx))
    got = tb.take_fill(torch.from_numpy(idx))
    np.testing.assert_array_equal(u32(got.recid), np.asarray(want.recid))
    np.testing.assert_array_equal(u32(got.num), np.asarray(want.num))
    np.testing.assert_array_equal(u32(got.strw), np.asarray(want.strw))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize(
    "kw", [{}, {"key_range": 7, "recid_start": 50}, {"zipf_a": 1.3}, {"str_len": 9}]
)
def test_generator_matches_jax(kw):
    want = jgen.generate_columns(12, seed=5, **kw)
    got = tgen.generate_columns(12, seed=5, **kw)
    for c in ("recid", "num", "strs", "valid"):
        np.testing.assert_array_equal(got[c], want[c])
    jb = jgen.generate_batch(12, seed=5, **kw)
    tb = tgen.generate_batch(12, seed=5, device="cpu", **kw)
    np.testing.assert_array_equal(u32(tb.strw), np.asarray(jb.strw))
    np.testing.assert_array_equal(u32(tb.num), np.asarray(jb.num))


def test_from_numpy_matches_jax_narrowing_and_nul_normalization():
    g = np.random.default_rng(11)
    n = 50
    strs = g.integers(1, 256, size=(n, 128)).astype(np.uint8)
    strs[:, 10:] = 0
    strs[::3, 4] = 0  # bytes after an embedded NUL must be zeroed
    recid = np.arange(n, dtype=np.uint32)
    num = full_range(g, n)
    jb = jbatch.RecordBatch.from_numpy(recid, num, strs)
    tb = tbatch.RecordBatch.from_numpy(recid, num, strs, device="cpu")
    assert tb.str_words == jb.str_words == 4
    np.testing.assert_array_equal(u32(tb.strw), np.asarray(jb.strw))
    np.testing.assert_array_equal(tb.to_numpy()["strs"], jb.to_numpy()["strs"])
    assert [w.shape for w in tkeys.key_words(tb, 3)] == [(n,)] * 5
    short = tfilter.truncate(tb, 7)
    assert short.nrows == 7 and short.str_words == 4


def test_blockfile_round_trip_against_jax(tmp_path):
    cols = jgen.generate_columns(7, seed=9)
    cols["valid"][::5] = False
    cols = {k: v[:650] for k, v in cols.items()}  # a partial last block
    t_path, j_path = tmp_path / "t.bin", tmp_path / "j.bin"
    assert tblock.write_blockfile(str(t_path), cols) == 7
    jblock.write_blockfile(str(j_path), cols)
    assert t_path.read_bytes() == j_path.read_bytes()
    jb = jblock.read_blockfile(str(t_path), prefer_native=False)
    tb = tblock.read_blockfile(str(j_path), device="cpu")
    np.testing.assert_array_equal(u32(tb.recid), np.asarray(jb.recid))
    np.testing.assert_array_equal(u32(tb.num), np.asarray(jb.num))
    np.testing.assert_array_equal(u32(tb.strw), np.asarray(jb.strw))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    # a batch writes the same bytes as its columns
    tblock.write_blockfile(str(t_path), tb)
    assert t_path.read_bytes() == j_path.read_bytes()
