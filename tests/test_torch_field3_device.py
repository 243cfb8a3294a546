"""The PyTorch port's device field-3 expansion against the JAX package.

``materialize_field3_device`` (K2's cumsum, K14's sources, K4's gather; on
the CPU their plain versions) emits probe row j ``mult[j]`` times into
``cap`` rows and returns the true total.  The same numpy inputs go through
the JAX package's function and the port's, and the port's is held against
its own host form ``materialize_field3`` (``np.repeat``), at K14's edges:
no output, a total past the capacity, a total below it, leading and
trailing zero multiplicities, one probe row holding every output row, a
capacity of 0.  The counterpart of ``tests/test_placement.py:150-161``.
Tolerance: exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model as M
from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32
from database_technology_algorithms_tpu_torch.kernels import expand_sources as k14
from database_technology_algorithms_tpu_torch.ops import hash_join as thash

jhash = importlib.import_module("database_technology_algorithms_tpu.ops.hash_join")


def both(cols: dict) -> tuple[JBatch, TBatch]:
    jb = JBatch.from_numpy(cols["recid"], cols["num"], cols["strs"], cols["valid"])
    tb = TBatch.from_jax_arrays(
        *(np.asarray(c) for c in (jb.recid, jb.num, jb.strw, jb.valid)), device="cpu")
    return jb, tb


def assert_same(got: TBatch, want: JBatch):
    for k in ("recid", "num", "strw"):
        np.testing.assert_array_equal(
            torch_to_u32(getattr(got, k)), np.asarray(getattr(want, k)).astype(np.uint32),
            err_msg=k)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid), err_msg="valid")


def edge_mult(case: str, n: int, g) -> np.ndarray:
    mult = g.integers(0, 4, size=n).astype(np.int32)
    if case == "no output":
        mult[:] = 0
    elif case == "zero at both ends":
        mult[: n // 5] = 0
        mult[-n // 5:] = 0
    elif case == "one row holds all":
        mult[:] = 0
        mult[n // 3] = 3 * n
    elif case == "first row holds all":
        mult[:] = 0
        mult[0] = 2 * n
    elif case == "last row holds all":
        mult[:] = 0
        mult[-1] = 2 * n
    return mult


CASES = ["random", "no output", "zero at both ends", "one row holds all", "first row holds all",
         "last row holds all"]
# the capacity as a function of the total: equal, past it, below it, none
CAPS = {"cap = total": lambda t: t, "cap > total": lambda t: t + 37,
        "cap < total": lambda t: t // 2, "cap = 0": lambda t: 0}


@pytest.mark.parametrize("cap_case", list(CAPS))
@pytest.mark.parametrize("case", CASES)
def test_materialize_field3_device_matches_jax_and_host(case, cap_case):
    n = 120
    g = np.random.default_rng(len(case))
    cols = M.random_cols(g, n, key_range=30)
    cols["num"][::5] |= np.uint32(1 << 31)
    jb, tb = both(cols)
    mult = edge_mult(case, n, g)
    total = int(mult.sum())
    cap = CAPS[cap_case](total)
    want, wtotal = jhash.materialize_field3_device(jb, jnp.asarray(mult), cap)
    got, gtotal = thash.materialize_field3_device(tb, torch.from_numpy(mult), cap)
    assert int(gtotal) == int(wtotal) == total  # the whole total, even past cap
    assert got.nrows == cap
    assert_same(got, want)
    host = thash.materialize_field3(tb, torch.from_numpy(mult > 0), torch.from_numpy(mult))
    live = min(total, cap)
    gn, hn = got.to_numpy(), host.to_numpy()  # byte columns: the stored widths may differ
    for k in ("recid", "num", "strs", "valid"):
        np.testing.assert_array_equal(gn[k][:live], hn[k][:live], err_msg=k)
        assert not gn[k][live:].any(), k


def test_materialize_field3_device_with_no_probe_rows():
    """No probe rows: the JAX form cannot take from an empty axis; the port
    returns `cap` fill rows and a total of 0."""
    cols = M.random_cols(np.random.default_rng(3), 0)
    jb, tb = both(cols)
    with pytest.raises(IndexError):
        jhash.materialize_field3_device(jb, jnp.zeros(0, jnp.int32), 5)
    got, gtotal = thash.materialize_field3_device(tb, torch.zeros(0, dtype=torch.int32), 5)
    assert int(gtotal) == 0 and got.nrows == 5
    assert not got.valid.any() and not got.recid.any() and not got.strw.any()
    out, total = thash.materialize_field3_device(tb, torch.zeros(0, dtype=torch.int32), 0)
    assert out.nrows == 0 and int(total) == 0


@pytest.mark.parametrize("cap_of", ["total", "4n"])
def test_field3_expansion_of_a_join_matches_jax(rng, cap_of):
    """The join's own multiplicities (field 3's (num, str) multimap)."""
    g = np.random.default_rng(150)
    bcols = M.random_cols(g, 150, key_range=12)
    pcols = M.random_cols(g, 150, key_range=12)
    jb, tb = both(bcols)
    jp, tp = both(pcols)
    jm, jmult, jn = jhash.hash_join_count(jb, jp, 3)
    tm, tmult, tn = thash.hash_join_count(tb, tp, 3)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tmult.numpy(), np.asarray(jmult))
    cap = int(tn) if cap_of == "total" else 4 * 150
    want, wtotal = jhash.materialize_field3_device(jp, jmult, cap)
    got, total = thash.materialize_field3_device(tp, tmult, cap)
    assert int(total) == int(wtotal) == int(tn)
    assert_same(got, want)
    host = thash.materialize_field3(tp, tm, tmult)
    assert host.nrows == int(total)
    gn, hn = got.to_numpy(), host.to_numpy()
    for k in ("recid", "num", "strs", "valid"):
        np.testing.assert_array_equal(gn[k][: int(total)], hn[k], err_msg=k)


@pytest.mark.parametrize("cap", [0, 1, 7, 64])
def test_expand_sources_plain_is_searchsorted(cap):
    """K14's contract on the CPU: the first j with c[j] > i below the total,
    the fill row past it (including a total past the capacity)."""
    mult = np.array([0, 3, 0, 0, 1, 5, 0, 2, 0], np.int32)
    c = np.cumsum(mult).astype(np.int32)
    src = k14.expand_sources(torch.from_numpy(c), torch.tensor(int(c[-1]), dtype=torch.int32),
                             cap)
    i = np.arange(cap)
    want = np.where(i < c[-1], np.searchsorted(c, i, side="right"), len(c))
    np.testing.assert_array_equal(src.numpy(), want)
    assert src.dtype == torch.int32
