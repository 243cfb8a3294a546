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
exact.  The look-back's status words (one flag bit, 31 bits of prefix) are
mirrored in Python and walked over per-tile digit counts up to 2^31 - 2 rows
in one digit, in order and out of order, against numpy's cumsum.
"""

import re
from pathlib import Path

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


def test_row_limit_is_the_32_bit_row_index():
    assert radix_plan.MAX_ROWS == (1 << 31) - 1  # the JAX sorts' own limit (int32 positions)
    radix_plan.check_rows("view_sort", radix_plan.MAX_ROWS)
    radix_plan.check_rows("words_sort", 1 << 30)
    with pytest.raises(ValueError, match="row index is 32-bit"):
        radix_plan.check_rows("view_sort", 1 << 31)


def cuh_constants(*names: str) -> dict:
    """The integer constexprs `names` of csrc/radix.cuh, as the compiler reads them."""
    text = (Path(radix_plan.__file__).parent.parent / "csrc" / "radix.cuh").read_text()
    out = {}
    for name in names:
        m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*([^;]+);", text)
        assert m, f"csrc/radix.cuh has no constexpr {name}"
        expr = re.sub(r"\((?:u?int\d+_t)\)", "", m.group(1))
        out[name] = eval(re.sub(r"\b(0x[0-9A-Fa-f]+|\d+)u\b", r"\1", expr), {"RS_THREADS": 512,
                                                                            "RS_ITEMS": 8})
    return out


def test_status_constants_match_the_kernel():
    got = cuh_constants("RS_TILE", "RS_LOOKBACK", "RS_PREFIX", "RS_COUNT_MASK", "RS_MAX_ROWS")
    assert got == {"RS_TILE": T, "RS_LOOKBACK": radix_plan.LOOKBACK,
                   "RS_PREFIX": radix_plan.STATUS_PREFIX,
                   "RS_COUNT_MASK": radix_plan.STATUS_PREFIX - 1,
                   "RS_MAX_ROWS": radix_plan.MAX_ROWS}


# The look-back's status words as onesweep_pass writes and rs_lookback reads
# them (csrc/radix.cuh), one digit's column: u32 words, 0 until published.
PREFIX = radix_plan.STATUS_PREFIX


def aggregate_word(count: int) -> int:
    word = count + 1
    assert 0 < word <= T + 1  # never the prefix flag, never "not published"
    return word


def prefix_word(prefix: int) -> int:
    assert 0 <= prefix <= radix_plan.MAX_ROWS  # the u32 sum the kernel makes stays below bit 31
    return PREFIX | prefix


def lookback_round(status: list, u: int, excl: int) -> tuple[int, int, bool]:
    """One round of rs_lookback from tile u down: (next u, excl, done).  It
    adds the words' low 31 bits up to the first prefix, then takes one off
    for each aggregate (its count plus one), in u32 arithmetic."""
    used, done = 0, False
    for w in range(radix_plan.LOOKBACK):
        sw = status[u - w] if u - w >= 0 else 0
        if sw == 0:
            break  # the kernel's later words are not used this round
        excl += sw & (PREFIX - 1)
        used = w + 1
        done = (sw & PREFIX) != 0
        if done:
            break
    return u - used, (excl - (used - done)) % (1 << 32), done


def walk_status(counts: np.ndarray, rng, resident: int, shuffle_from: int) -> tuple[list, list]:
    """Each tile's exclusive offset of one digit, and the status words at the
    end.  Tiles take their index in order (the tile counter); before tile
    `shuffle_from` one runs at a time, then `resident` are in flight and a
    random one moves a step: it publishes its aggregate (tile 0 its prefix),
    or runs one look-back round and, when that meets a prefix, publishes its
    own."""
    n_tiles = len(counts)
    status, excl = [0] * n_tiles, [None] * n_tiles
    live, nxt = [], 0
    while nxt < n_tiles or live:
        while nxt < n_tiles and len(live) < (1 if nxt < shuffle_from else resident):
            live.append([nxt, False, nxt - 1, 0])  # tile, published, u, excl
            nxt += 1
        i = int(rng.integers(len(live))) if len(live) > 1 else 0
        tile = live[i]
        t = tile[0]
        if not tile[1]:
            tile[1] = True
            if t == 0:
                status[0], excl[0] = prefix_word(int(counts[0])), 0
                live.pop(i)
            else:
                status[t] = aggregate_word(int(counts[t]))
            continue
        tile[2], tile[3], done = lookback_round(status, tile[2], tile[3])
        if done:
            excl[t] = tile[3]
            status[t] = prefix_word(tile[3] + int(counts[t]))
            live.pop(i)
    return excl, status


def status_case(case: str, g) -> tuple[np.ndarray, int, int]:
    """[tiles, digits] counts a tile and digit, the resident tiles and where
    the random interleaving starts."""
    if case == "one digit of 2^31 - 2 rows":
        # MAX_ROWS rows in 524,288 tiles: one row in another digit, the last tile one short
        n_tiles = -(-radix_plan.MAX_ROWS // T)
        counts = np.full((n_tiles, 1), T, np.int64)
        counts[int(g.integers(n_tiles - 1)), 0] -= 1
        counts[-1, 0] -= 1
        assert n_tiles == 524_288 and counts.sum() == (1 << 31) - 2
        return counts, 64, n_tiles - 3000
    if case.startswith("a digit crossing 2^30"):
        # the digit's exclusive offset first reaches 2^30 at the last tile (in
        # order: it reads the prefix of the tile before) or 1500 tiles before
        # it (3000 tiles in flight out of order around it)
        last = case.endswith("last tile")
        per = g.integers(T - 200, T + 1, size=(1 << 30) // (T - 200) + 1501)
        n_tiles = int(np.searchsorted(np.cumsum(per), 1 << 30)) + (2 if last else 1501)
        counts = per[:n_tiles, None].astype(np.int64)
        excl = np.cumsum(counts[:, 0]) - counts[:, 0]
        cross = n_tiles - (1 if last else 1500)
        assert excl[cross - 1] < 1 << 30 <= excl[cross]
        return counts, 132, n_tiles if last else n_tiles - 3000
    # out of order: 12 digits, 1500 tiles, 132 in flight from the start
    counts = g.multinomial(T, g.dirichlet(np.full(12, 0.3)), size=1500).astype(np.int64)
    return counts, 132, 0


@pytest.mark.parametrize("case", ["one digit of 2^31 - 2 rows",
                                  "a digit crossing 2^30 at the last tile",
                                  "a digit crossing 2^30 out of order", "out of order"])
def test_status_word_lookback_offsets(case):
    """The look-back's exclusive offset of every tile, from the status words
    published in the kernel's encoding, equals numpy's cumsum of the counts,
    past the 30-bit count that the old two-flag word held."""
    g = np.random.default_rng(len(case))
    counts, resident, shuffle_from = status_case(case, g)
    for d in range(counts.shape[1]):
        col = counts[:, d]
        excl, status = walk_status(col, g, resident, shuffle_from)
        inc = np.cumsum(col)
        np.testing.assert_array_equal(np.asarray(excl, np.int64), inc - col)
        np.testing.assert_array_equal(np.asarray(status, np.int64), PREFIX | inc)
    if case != "out of order":
        assert counts[:, 0].sum() > (1 << 30) - 1


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
