"""K1's and K5's gather of their extra words (``gather_words_*`` in
``csrc/radix.cuh``), emulated in numpy under its plan
(``kernels/radix_plan.gather_packed``, ``gather_groups``).

The emulation walks the launches as ``gather_extras`` makes them: the word
groups (packed groups of 4, a last group of one word direct; direct groups
of ``MAX_WORDS`` = 8), each packed group's interleave into rows of 2 or 4
words in the sort's free buffers (16-byte aligned, the pad words zero),
then a thread's 4 rows: its order entries by one 16-byte load, its rows'
loads, and each word's 4 outputs by one 16-byte store where the run is
whole, else one by one.  Every output word must be written exactly once and
equal ``w[perm]``; the order, the packed buffer and the sources are only
read where a row lies.  Rows that end inside a thread's run, 1-9 words
(past MAX_WORDS); the plan's choices themselves; and K1's and K5's plain
versions against the JAX package with extras.  The CUDA kernels run on the
card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from database_technology_algorithms_tpu.ops.sort import packed_u32_view_sort as jview_sort
from database_technology_algorithms_tpu_torch.kernels import radix_plan
from database_technology_algorithms_tpu_torch.kernels.radix_sort import view_sort_plain
from database_technology_algorithms_tpu_torch.kernels.words_sort import words_sort_plain

ROWS, THREADS = 4, 256  # GW_ROWS and GW_THREADS in csrc/radix.cuh


def emulate_gather(perm: np.ndarray, words: list, packed: bool) -> list:
    """The outputs the kernels write in the form `packed`, thread by thread."""
    n, nextra = perm.shape[0], len(words)
    outs = [np.zeros(n, np.uint32) for _ in words]
    written = [np.zeros(n, np.int64) for _ in words]
    perm_read = np.zeros(n, np.int64)
    for first, cnt, pw in radix_plan.gather_groups(nextra, packed):
        group = words[first:first + cnt]
        if pw:
            buf = np.zeros((n, pw), np.uint32)  # the pack: one thread a row
            for k, w in enumerate(group):
                buf[:, k] = w
        blocks = -(-n // (THREADS * ROWS))
        starts = np.arange(blocks * THREADS) * ROWS
        starts = starts[starts < n]
        left = n - starts
        whole = left >= ROWS
        for r in range(ROWS):
            rows_r = starts + r
            on = whole | (r < left)
            rows = rows_r[on]
            perm_read[rows] += 1
            src = perm[rows]
            assert (src >= 0).all() and (src < n).all()
            for k in range(cnt):
                val = buf[src, k] if pw else group[k][src]
                outs[first + k][rows] = val
                written[first + k][rows] += 1
    for w in written:
        assert (w == 1).all()
    assert (perm_read == len(radix_plan.gather_groups(nextra, packed))).all()
    return outs


def gather_case(n: int, m: int, seed: int):
    g = np.random.default_rng(seed)
    perm = g.permutation(n).astype(np.int32)
    words = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32) for _ in range(m)]
    return perm, words


# rows that end inside a thread's run and a block's, and many blocks
ROWS_CASES = [1, 3, 4, 5, 7, 8, 9, 1023, 1025, THREADS * 4 + 3, THREADS * 8 * 3 + 5, 70_001]


@pytest.mark.parametrize("n", ROWS_CASES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [2, 3, 5, 9])
def test_gather_emulation_matches_the_order(n, packed, m):
    """A packed group of 2, a padded group of 3, a group and a direct word,
    two groups and a direct word (direct: one launch, two past 8 words)."""
    perm, words = gather_case(n, m, n + m)
    for got, w in zip(emulate_gather(perm, words, packed), words):
        np.testing.assert_array_equal(got, w[perm])


@pytest.mark.parametrize("m", list(range(1, 10)))
@pytest.mark.parametrize("packed", [False, True])
def test_gather_word_groups(m, packed):
    """1-9 words: packed groups of 4 (a group of 3 padded to 4, a last word
    alone going direct), direct groups of MAX_WORDS = 8 (9 words: two
    launches)."""
    perm, words = gather_case(2 * THREADS * 4 + 1, m, m)
    groups = radix_plan.gather_groups(m, packed)
    assert sum(cnt for _, cnt, _ in groups) == m
    assert [f for f, _, _ in groups] == list(range(0, m, 4 if packed else 8))
    for _, cnt, pw in groups:
        assert pw == (0 if not packed or cnt == 1 else 2 if cnt == 2 else 4)
        assert cnt <= (radix_plan.GATHER_PACK_WORDS if packed else radix_plan.GATHER_DIRECT_WORDS)
    for got, w in zip(emulate_gather(perm, words, packed), words):
        np.testing.assert_array_equal(got, w[perm])


@pytest.mark.parametrize("m", list(range(1, 10)))
def test_gather_plan_form(m):
    """Packed where at least two words pass GATHER_PACK_BYTES, direct for
    one word or within it."""
    lim = radix_plan.GATHER_PACK_BYTES
    n_past = lim // (4 * m) + 1  # m words of n rows pass the limit
    assert radix_plan.gather_packed(n_past, m) == (m >= 2)
    assert not radix_plan.gather_packed(lim // (4 * m), m)
    assert radix_plan.gather_packed(1 << 24, m) == (m >= 2)
    # the sweep's shapes: 262,144 rows of 2 words direct, 1M rows packed
    assert not radix_plan.gather_packed(262_144, 2)
    assert radix_plan.gather_packed(1 << 20, 2)
    assert radix_plan.gather_groups(0, True) == []


@pytest.mark.parametrize("n", [1, 5, 3000])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 9])
def test_sorts_with_extras_match_jax(m, n):
    """K1's and K5's plain versions carry their extra words through the
    same order as the JAX package's packed_u32_view_sort with payloads."""
    g = np.random.default_rng(m * n)
    key = g.integers(0, 400, size=n).astype(np.uint32)
    inact = g.random(n) < 0.2
    extra = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32) for _ in range(m)]
    t = tuple(torch.from_numpy(x.view(np.int32)) for x in extra)
    tk = torch.from_numpy(key.view(np.int32))
    _, perm1, _, ex1 = view_sort_plain(torch.from_numpy(inact), tk, t)
    perm5, _, ex5 = words_sort_plain([tk], torch.from_numpy(inact), t)
    _, jperm, _, jex = jview_sort(jnp.asarray(inact), jnp.asarray(key),
                                  tuple(jnp.asarray(x) for x in extra))
    np.testing.assert_array_equal(perm1.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(perm5.numpy(), np.asarray(jperm))
    for a, b, w in zip(ex1, ex5, jex):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(w))
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(w))
