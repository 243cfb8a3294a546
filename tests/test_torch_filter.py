"""The PyTorch port's selection filter against the JAX package, bit for bit.

The same numpy columns, made from a seed, go through the JAX package's
``ops/filter.py`` (on the CPU, conftest) and the port's (on CPU tensors,
where every kernel wrapper runs its plain version).  Keys carry bit 31 in
``num`` and ``recid``, and the range bounds lie on both sides of 2^31, where
a signed compare of the port's int32 words would go wrong.  Every value is
an integer or a bool: the tolerance is exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.ops import filter as tfilter

jfilter = importlib.import_module("database_technology_algorithms_tpu.ops.filter")

ROUTES = ["gather", "sort", "sort2d"]
HI = 1 << 31


def make_cols(n: int, seed: int, str_bytes: int = 8) -> dict:
    """num and recid over the whole u32 range (about half >= 2^31), strings
    with planted "Hola", "Hola\\0garbage" (normalized at ingestion) and a
    prefix of the wide constant, about 15% of rows valid=False."""
    g = np.random.default_rng(seed)
    strs = np.zeros((n, 128), dtype=np.uint8)
    strs[:, :5] = g.integers(97, 100, size=(n, 5), dtype=np.uint8)
    strs[:, 5:str_bytes] = g.integers(97, 123, size=(n, str_bytes - 5), dtype=np.uint8)
    strs[::7, :] = 0
    strs[::7, :4] = np.frombuffer(b"Hola", dtype=np.uint8)
    strs[3::11, :] = 0
    strs[3::11, :12] = np.frombuffer(b"Hola\x00garbage", dtype=np.uint8)
    strs[5::13, :] = 0
    strs[5::13, :str_bytes] = np.frombuffer(b"abcdefghijklmnop"[:str_bytes], dtype=np.uint8)
    return {
        "recid": g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
        "num": g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
        "strs": strs,
        "valid": g.random(n) > 0.15,
    }


def both(cols: dict) -> tuple[JBatch, TBatch]:
    jb = JBatch.from_numpy(cols["recid"], cols["num"], cols["strs"], cols["valid"])
    tb = TBatch.from_jax_arrays(
        *(np.asarray(c) for c in (jb.recid, jb.num, jb.strw, jb.valid)), device="cpu")
    return jb, tb


def assert_same_batch(got: TBatch, want: JBatch):
    for k in ("recid", "num", "strw"):
        np.testing.assert_array_equal(
            torch_to_u32(getattr(got, k)), np.asarray(getattr(want, k)), err_msg=k)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid), err_msg="valid")


# (name, JAX predicate, port predicate): the same arguments to each package
PREDICATES = {
    "valid": lambda m: m.pred_valid(),
    "num lo<2^31<=hi": lambda m: m.pred_num_range(HI - 12345, HI + 2**29),
    "num lo>2^31": lambda m: m.pred_num_range(HI + 5, None),
    "num hi>2^31": lambda m: m.pred_num_range(None, HI + 7),
    "num hi<2^31": lambda m: m.pred_num_range(None, 2**30),
    "num empty": lambda m: m.pred_num_range(HI + 9, HI + 9),
    "num top": lambda m: m.pred_num_range(2**32 - 2**20, 2**32 - 1),
    "recid lo<2^31<=hi": lambda m: m.pred_recid_range(2**30, HI + 2**30),
    "recid lo>2^31": lambda m: m.pred_recid_range(HI, None),
    "recid hi>2^31": lambda m: m.pred_recid_range(None, HI + 1),
    "str Hola": lambda m: m.pred_str_eq(b"Hola"),
    "str Hola NUL garbage": lambda m: m.pred_str_eq(b"Hola\x00garbage"),
    "str wider than stored": lambda m: m.pred_str_eq(b"abcdefghijkl"),
    "str prefix of stored": lambda m: m.pred_str_eq(b"abcdefgh"),
    "str empty": lambda m: m.pred_str_eq(b""),
    "and valid num": lambda m: m.pred_and(m.pred_valid(), m.pred_num_range(HI - 2**28, None)),
    "and three": lambda m: m.pred_and(m.pred_valid(), m.pred_recid_range(None, HI + 2**30),
                                      m.pred_num_range(2**29, None)),
}


@pytest.mark.parametrize("name", list(PREDICATES))
def test_predicate_masks_match_jax(name):
    jb, tb = both(make_cols(600, seed=1))
    want = np.asarray(PREDICATES[name](jfilter)(jb))
    got = PREDICATES[name](tfilter)(tb)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    if name.startswith("num") or name.startswith("recid"):
        assert 0 < want.sum() < want.size or name == "num empty"


def test_pred_str_eq_normalizes_the_constant():
    jb, tb = both(make_cols(600, seed=2))
    a = tfilter.pred_str_eq(b"Hola")(tb)
    b = tfilter.pred_str_eq(b"Hola\x00garbage")(tb)
    assert torch.equal(a, b) and int(a.sum()) > 0
    # a constant past the stored width (2 words) matches nothing, not even
    # the rows that hold its first 8 bytes
    assert tb.str_words == 2
    assert int(tfilter.pred_str_eq(b"abcdefgh")(tb).sum()) > 0
    assert int(tfilter.pred_str_eq(b"abcdefghijkl")(tb).sum()) == 0


@pytest.mark.parametrize("name", ["valid", "num lo<2^31<=hi", "str Hola", "and three"])
@pytest.mark.parametrize("count", [None, 0, 1, 417, 600])
def test_filter_batch_matches_jax(name, count):
    jb, tb = both(make_cols(600, seed=3))
    want, wn = jfilter.filter_batch(
        jb, PREDICATES[name](jfilter), count=None if count is None else jnp.int32(count))
    got, n = tfilter.filter_batch(tb, PREDICATES[name](tfilter), count=count)
    assert int(n) == int(wn)
    assert_same_batch(got, want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("count", [None, 333])
@pytest.mark.parametrize("str_bytes", [8, 14])
def test_compact_matches_jax_on_every_route(route, count, str_bytes):
    cols = make_cols(500, seed=4, str_bytes=str_bytes)
    jb, tb = both(cols)
    mask = np.random.default_rng(5).random(500) < 0.4
    mask[:3] = True  # live rows past the count must not survive
    mask[-3:] = True
    want, wn = jfilter.compact(jb, jnp.asarray(mask), JConfig(materialize=route),
                               count=None if count is None else jnp.int32(count))
    got, n = tfilter.compact(tb, torch.from_numpy(mask), TConfig(materialize=route),
                             count=count)
    assert int(n) == int(wn)
    assert_same_batch(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_compact_with_count_drops_zeroed_padding(route):
    """Padding rows past the live count (num=0, str='') pass a predicate
    that holds for zeros, and still never survive."""
    cols = make_cols(300, seed=6)
    for k in ("recid", "num"):
        cols[k][200:] = 0
    cols["strs"][200:] = 0
    jb, tb = both(cols)
    jmask = jfilter.pred_num_range(None, 10)(jb)
    tmask = tfilter.pred_num_range(None, 10)(tb)
    want, wn = jfilter.compact(jb, jmask, JConfig(materialize=route), count=jnp.int32(200))
    got, n = tfilter.compact(tb, tmask, TConfig(materialize=route), count=200)
    assert int(n) == int(wn) == int((cols["num"][:200] < 10).sum())
    assert_same_batch(got, want)
