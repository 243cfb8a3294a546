"""The pass schedule of the one-sweep radix sort (K1, K5) on the CPU.

``kernels/radix_plan.py`` holds the schedule the wrappers hand to the CUDA
kernels: which (word, shift, flag) passes run, the 9-bit top digit that
carries the inactive flag, and which digits are trivial (one digit for every
row), which the kernel skips instead of scattering.  Here a plain
torch emulation applies that schedule as the kernel does, one stable sort
per digit that is not trivial, each word read through the order so far, and
is held against the plain versions (``view_sort_plain``,
``words_sort_plain``) and against the JAX package (``packed_u32_view_sort``,
``sort_keys``).  Inputs are made from a seed with numpy; every comparison is
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu import batch as jbatch
from database_technology_algorithms_tpu.ops import sort as jsort
from database_technology_algorithms_tpu_torch import batch as tbatch
from database_technology_algorithms_tpu_torch.kernels import radix_plan
from database_technology_algorithms_tpu_torch.kernels.radix_sort import view_sort_plain
from database_technology_algorithms_tpu_torch.kernels.words_sort import words_sort_plain

CPU = torch.device("cpu")
T = radix_plan.TILE
SIZES = [0, 1, T - 1, T + 1]
CASES = ["high", "inactive", "equal", "zero high bytes", "mixed"]


def t32(a) -> torch.Tensor:
    return tbatch.u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


def emulate(words, inact, sched):
    """The kernel's order: for each pass that is not trivial, one stable sort
    of the rows by the pass's digit, the word read through the order so far;
    trivial passes leave the order as it is."""
    n = words[0].shape[0]
    perm = torch.arange(n)
    for p, trivial in zip(sched, radix_plan.trivial_passes(words, inact, sched), strict=True):
        if trivial:
            continue
        d = radix_plan.pass_digits([w[perm] for w in words],
                                   None if inact is None else inact[perm], p)
        perm = perm[torch.sort(d, stable=True).indices]
    s_act = torch.ones(n, dtype=torch.bool) if inact is None else ~inact[perm]
    return perm.to(torch.int32), s_act


def make_keys(g, case, n, m):
    """u32 [n, m] key words and the inactive mask of one case."""
    if case == "equal":
        mat = np.full((n, m), 0x9E3779B9, np.uint32)
    elif case == "zero high bytes":  # small keys: the top digits are trivial
        mat = g.integers(0, 1 << 12, size=(n, m)).astype(np.uint32)
    elif case == "high":  # every word >= 2^31
        mat = g.integers(1 << 31, 1 << 32, size=(n, m), dtype=np.uint64).astype(np.uint32)
    else:  # few values a word, so ties reach the last word and the row index
        mat = (g.integers(0, 4, size=(n, m)).astype(np.uint32) << 30) | g.integers(
            0, 3, size=(n, m)).astype(np.uint32)
    if case == "inactive":
        inact = np.ones(n, bool)
    elif case in ("equal", "zero high bytes"):
        inact = np.zeros(n, bool)
    else:
        inact = g.random(n) < 0.2
    return mat, inact


def test_schedules():
    assert radix_plan.view_sort_schedule() == ((0, 0, 0), (0, 8, 0), (0, 16, 0), (0, 24, 1))
    sched = radix_plan.words_sort_schedule(3, False)
    assert len(sched) == 12 and sched[0] == (2, 0, 0) and sched[-1] == (0, 24, 0)
    assert radix_plan.words_sort_schedule(2, True)[-1] == (0, 24, 1)
    assert list(radix_plan.schedule_array(sched))[:6] == [2, 0, 0, 2, 8, 0]
    with pytest.raises(ValueError, match="key words"):
        radix_plan.words_sort_schedule(radix_plan.MAX_WORDS + 1, True)


def test_row_limit_names_the_status_word():
    radix_plan.check_rows("view_sort", radix_plan.MAX_ROWS)
    with pytest.raises(ValueError, match="30-bit count"):
        radix_plan.check_rows("view_sort", radix_plan.MAX_ROWS + 1)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_view_sort_schedule_matches_plain_and_jax(case, n):
    g = np.random.default_rng(n + 17 * len(case))
    mat, inact = make_keys(g, case, n, 1)
    key, tinact = t32(mat[:, 0]), torch.from_numpy(inact)
    sched = radix_plan.view_sort_schedule()
    perm, s_act = emulate([key], tinact, sched)
    s_key, want_perm, want_act, _ = view_sort_plain(tinact, key)
    np.testing.assert_array_equal(perm.numpy(), want_perm.numpy())
    np.testing.assert_array_equal(s_act.numpy(), want_act.numpy())
    np.testing.assert_array_equal(key[perm.long()].numpy(), s_key.numpy())
    jkey, jperm, jact, _ = jsort.packed_u32_view_sort(
        jnp.asarray(inact.astype(np.uint32)), jnp.asarray(mat[:, 0]))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(s_act.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(tbatch.torch_to_u32(s_key), np.asarray(jkey))
    trivial = radix_plan.trivial_passes([key], tinact, sched)
    if n <= 1 or case == "equal":
        assert all(trivial)
    elif case == "zero high bytes":  # keys below 2^12, every row active
        assert trivial == [False, False, True, True]
    elif case == "inactive":  # the flag is constant, the top key byte is not
        assert not trivial[-1]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", CASES + ["no mask"])
@pytest.mark.parametrize("m", [1, 2, 3, 9])
def test_words_sort_schedule_matches_plain_and_jax(m, case, n):
    g = np.random.default_rng(1000 * m + n + len(case))
    mat, inact = make_keys(g, "mixed" if case == "no mask" else case, n, m)
    cols = t32(mat)
    words = [cols[:, j] for j in range(m)]  # strided columns, as K5 reads them
    tinact = None if case == "no mask" else torch.from_numpy(inact)
    sched = radix_plan.words_sort_schedule(m, tinact is not None)
    assert len(sched) == 4 * m
    perm, s_act = emulate(words, tinact, sched)
    want_perm, want_act, _ = words_sort_plain(words, tinact)
    np.testing.assert_array_equal(perm.numpy(), want_perm.numpy())
    np.testing.assert_array_equal(s_act.numpy(), want_act.numpy())
    trivial = radix_plan.trivial_passes(words, tinact, sched)
    if n <= 1 or case == "equal":
        assert all(trivial)
    elif case == "zero high bytes":  # words below 2^12, every row active
        assert trivial == [s >= 16 for _, s, _ in sched]
    if n == 0:
        return  # the JAX sort_keys takes no empty batch; the plain version is the reference
    jb = jbatch.RecordBatch(recid=jnp.zeros(n, jnp.uint32), num=jnp.zeros(n, jnp.uint32),
                            strw=jnp.asarray(mat), valid=jnp.ones(n, bool))
    pre = () if tinact is None else (jnp.asarray(inact.astype(np.uint32)),)
    view = jsort.sort_keys(jb, 2, pre_words=pre)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(view.perm))
