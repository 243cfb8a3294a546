"""The distributed plan's kernels, emulated in numpy as the card runs them,
against their plain torch versions and the JAX package.

- K19 (``csrc/topk_runs.cu``): each position's key, (run count << 32) |
  ~position, its run's count found by a binary search for the run's end in
  the sorted active prefix; each tile's k largest keys by k block-wide
  maxima; the k largest of the tiles' winners.  At the plan's tile and at
  small tiles that every long run crosses.
- K20 (``csrc/hot_set.cu``): a thread a candidate, the counts of equal
  candidates summed in 32 bits, the first occurrence, the signed threshold.
- K21 (``csrc/hot_set.cu``): the hot list's non-sentinel entries copied in
  any order, a row against each.
- K22 (``csrc/range_dest.cu``): the plan's path and grid
  (``dist_plan.range_plan``); on the vector path a thread's 4 rows by one
  16-byte load a word and the tail's n % 4 rows by the thread past the last
  whole group, on the scalar path ``RANGE_ROWS`` rows a thread,
  ``RANGE_THREADS`` apart; every row written once; each splitter compared
  in the branch-free form (gt |= eq & (w > s); eq &= w == s), unsigned.
- K9's fill (``csrc/stage_cells.cu``): the dead slots of the key-only pack
  hold 0xFFFFFFFF (``tests/test_torch_cells_schedule.py``'s emulation with
  a fill).

Every value is an integer or a bool, so every comparison is exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.kernels import dist_plan
from database_technology_algorithms_tpu_torch.kernels.hot_set import (
    hot_hashes, hot_hashes_plain, in_hot_set, in_hot_set_plain)
from database_technology_algorithms_tpu_torch.kernels.range_dest import (
    range_dest, range_dest_plain)
from database_technology_algorithms_tpu_torch.kernels.stage_cells import stage_to_cells
from database_technology_algorithms_tpu_torch.kernels.topk_runs import topk_runs, topk_runs_plain
from database_technology_algorithms_tpu_torch.parallel import dist_ops as tdist
from test_torch_cells_schedule import GEOMETRIES, emulate_stage

jskew = importlib.import_module("database_technology_algorithms_tpu.parallel.skew")
jdist = importlib.import_module("database_technology_algorithms_tpu.parallel.dist_ops")
joverlap = importlib.import_module("database_technology_algorithms_tpu.parallel.overlap")
CPU = torch.device("cpu")
M32 = 0xFFFFFFFF


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


# ---------------------------------------------------------------------------
# K19


def k19_emulate(hs: np.ndarray, nact: int, k: int, tile: int) -> tuple[np.ndarray, np.ndarray]:
    """csrc/topk_runs.cu at a tile of `tile` positions."""
    hs = np.asarray(hs, np.uint64)
    n = len(hs)
    nact = min(max(nact, 0), n)

    def key(i):
        cnt = 0
        if i < nact and (i == 0 or hs[i - 1] != hs[i]):
            lo, hi = i + 1, nact  # the first position past the run
            while lo < hi:
                mid = lo + (hi - lo) // 2
                if hs[mid] == hs[i]:
                    lo = mid + 1
                else:
                    hi = mid
            cnt = lo - i
        return (cnt << 32) | (~i & M32)

    winners = []
    for t0 in range(0, n, tile):
        keys = [key(i) for i in range(t0, min(t0 + tile, n))]
        keys += [0] * (tile - len(keys))  # no position: below every key
        for _ in range(k):
            best = max(keys)
            if best:
                keys[keys.index(best)] = 0
            winners.append(best)
    out_h, out_c = [], []
    for _ in range(k):
        best = max(winners)
        winners[winners.index(best)] = 0
        out_h.append(hs[~best & M32])
        out_c.append(best >> 32)
    return np.array(out_h, np.uint32), np.array(out_c, np.int32)


def topk_input(case: str, g) -> tuple[np.ndarray, int, int]:
    """(sorted masked hashes, active rows, k) of one K19 case."""
    n, k = 3000, 16
    if case == "n < k":  # local_topk_hashes clamps k to n
        n, k = 5, 5
    if case == "single run":
        h = np.full(n, 2**31 + 3, np.uint64)
    elif case == "run crossing every tile":
        h = np.concatenate([np.full(2500, 7), g.integers(8, 2**32, 500)])
    elif case == "ties at the k-th place":
        h = np.repeat(g.integers(0, 2**32, n // 5, dtype=np.uint64), 5)[:n]
        h[:40] = 11  # one longer run, then many of 5
    elif case == "live 0xFFFFFFFF":
        h = np.concatenate([g.integers(0, 50, n - 300), np.full(300, M32)])
    else:
        h = g.integers(0, 2**32, n, dtype=np.uint64) if case != "zipf" else (
            g.zipf(1.2, n) * 2654435761 % 2**32)
    nact = {"all dead": 0, "n < k": 3}.get(case, int(0.8 * n))
    if case == "live 0xFFFFFFFF":
        nact = n - 100
    live = np.sort(np.asarray(h[:nact], np.uint64))
    hs = np.concatenate([live, np.full(n - nact, M32)]).astype(np.uint32)
    return hs, nact, k


TOPK_CASES = ["zipf", "random", "single run", "all dead", "n < k", "run crossing every tile",
              "ties at the k-th place", "live 0xFFFFFFFF"]


@pytest.mark.parametrize("tile", [dist_plan.TOPK_TILE, 256, 33])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_k19_emulation_matches_plain_and_jax(case, tile):
    g = np.random.default_rng(len(case))
    hs, nact, k = topk_input(case, g)
    emu = k19_emulate(hs, nact, k, tile)
    got = topk_runs_plain(t32(hs), nact, k)
    np.testing.assert_array_equal(torch_to_u32(got[0]), emu[0])
    np.testing.assert_array_equal(got[1].numpy(), emu[1])
    # the JAX package sorts the masked hashes itself: any order of the live
    # rows with the dead ones anywhere gives the same arrays
    n = len(hs)
    perm = g.permutation(n)
    active = np.arange(n)[perm] < nact
    wh, wc = jskew.local_topk_hashes(jnp.asarray(hs[perm]), jnp.asarray(active), k)
    np.testing.assert_array_equal(np.asarray(wh), emu[0])
    np.testing.assert_array_equal(np.asarray(wc), emu[1])


def test_k19_count_on_the_device_and_refusals():
    hs, nact, k = topk_input("zipf", np.random.default_rng(2))
    a = topk_runs(t32(hs), torch.tensor(nact, dtype=torch.int32), k)
    b = topk_runs(t32(hs), nact, k)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert dist_plan.topk_scratch_words(len(hs), k) == 2 * k * dist_plan.topk_tiles(len(hs))
    for bad in (0, len(hs) + 1, dist_plan.TOPK_MAX_K + 1):
        with pytest.raises(ValueError, match="K19"):
            topk_runs(t32(hs), nact, bad)


# ---------------------------------------------------------------------------
# K20 and K21


def k20_emulate(gh, gc, thr) -> np.ndarray:
    gh, gc = np.asarray(gh, np.uint32), np.asarray(gc, np.int64)
    out = np.full(len(gh), M32, np.uint32)
    for i in range(len(gh)):
        tot, first = 0, True
        for j in range(len(gh)):
            if gh[j] == gh[i]:
                tot = (tot + int(gc[j])) & M32
                first &= j >= i
        tot = tot - (1 << 32) if tot >= 1 << 31 else tot
        if first and tot > thr and gh[i] != M32:
            out[i] = gh[i]
    return out


def candidates(case: str, g, m: int = 64):
    gh = g.choice(np.array([5, 2**31 + 1, 9, M32, 12], np.uint64), m).astype(np.uint32)
    gc = g.integers(0, 40, m).astype(np.int64)
    if case == "all sentinels":
        gh[:] = M32
    elif case == "all equal":
        gh[:] = 2**31 + 77
    elif case == "wrapping sum":
        gc[:] = 2**30  # the int32 sum wraps negative
    return gh, gc.astype(np.int32)


@pytest.mark.parametrize("thr", [-5, 1, 30, 200])
@pytest.mark.parametrize("case", ["mixed", "all sentinels", "all equal", "wrapping sum"])
def test_k20_emulation_matches_plain(case, thr):
    gh, gc = candidates(case, np.random.default_rng(thr + len(case)))
    emu = k20_emulate(gh, gc, thr)
    for t in (thr, torch.tensor(thr, dtype=torch.int32)):
        np.testing.assert_array_equal(torch_to_u32(hot_hashes(t32(gh), torch.from_numpy(gc), t)),
                                      emu)
    if case == "wrapping sum" and thr == 1:  # 2^30 + 2^30 wraps to -2^31: not hot
        gh3, gc3 = np.array([5, 5, 9], np.uint32), np.full(3, 2**30, np.int32)
        np.testing.assert_array_equal(k20_emulate(gh3, gc3, 1), [M32, M32, 9])
        np.testing.assert_array_equal(
            torch_to_u32(hot_hashes(t32(gh3), torch.from_numpy(gc3), 1)), [M32, M32, 9])


def test_k20_refuses_past_shared_memory():
    n = dist_plan.HOT_MAX_CANDIDATES + 1
    with pytest.raises(ValueError, match="K20"):
        hot_hashes(torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32), 1)
    assert hot_hashes_plain(torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32), 1).numel() == 0


def k21_emulate(hashes, hot) -> np.ndarray:
    live = [int(v) for v in np.asarray(hot, np.uint32) if v != M32]  # any order
    return np.array([any(int(h) == v for v in live) for h in np.asarray(hashes, np.uint32)],
                    bool)


@pytest.mark.parametrize("case", ["mixed", "empty hot list", "no list", "every row hot"])
def test_k21_emulation_matches_plain_and_jax(case):
    g = np.random.default_rng(len(case))
    h = g.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32)
    h[::7] = M32
    hot = np.full(0 if case == "no list" else 128, M32, np.uint32)
    if case == "mixed":
        hot[g.choice(128, 9, replace=False)] = g.choice(h, 9)
    elif case == "every row hot":
        h = g.choice(np.array([3, 2**31 + 3], np.uint32), 2000)
        hot[[0, 127]] = [3, 2**31 + 3]
    emu = k21_emulate(h, hot)
    np.testing.assert_array_equal(in_hot_set(t32(h), t32(hot)).numpy(), emu)
    np.testing.assert_array_equal(in_hot_set_plain(t32(h), t32(hot)).numpy(), emu)
    if len(hot):
        np.testing.assert_array_equal(np.asarray(jskew.in_hash_set(jnp.asarray(h),
                                                                   jnp.asarray(hot))), emu)
    assert emu.any() == (case in ("mixed", "every row hot"))


# ---------------------------------------------------------------------------
# K22


def k22_count(keys: np.ndarray, spl_smem: np.ndarray, ns: int) -> np.ndarray:
    """The splitters each of a thread's rows (keys [R, NW], u32) is >= to,
    from the word-major shared copy ``spl_smem[k * ns + s]``."""
    nw = keys.shape[1]
    cnt = np.zeros(len(keys), np.int32)
    for s in range(ns):
        gt, eq = np.zeros(len(keys), bool), np.ones(len(keys), bool)
        for k in range(nw):
            b = spl_smem[k * ns + s]
            gt |= eq & (keys[:, k] > b)
            eq &= keys[:, k] == b
        cnt += gt | eq
    return cnt


def k22_emulate(words, splitters, plan) -> np.ndarray:
    """csrc/range_dest.cu under `plan` = (vector path, blocks), thread by
    thread; every row must be written exactly once."""
    vec, blocks = plan
    rows = dist_plan.RANGE_ROWS
    words = np.stack([np.asarray(w, np.uint32) for w in words], 1)
    ns = len(splitters[0])
    spl_smem = np.concatenate([np.asarray(s, np.uint32) for s in splitters])  # word-major
    n, threads = len(words), dist_plan.RANGE_THREADS
    out, written = np.zeros(n, np.int32), np.zeros(n, np.int64)
    full = n // rows
    for b in range(blocks):
        for t in range(threads):
            if vec:
                grp = b * threads + t
                if grp < full:  # one 16-byte load a word, one 16-byte store
                    mine = np.arange(rows * grp, rows * grp + rows)
                elif grp == full:  # the tail, row by row
                    mine = np.arange(rows * full, n)
                else:
                    continue
            else:
                mine = b * threads * rows + t + threads * np.arange(rows)
                mine = mine[mine < n]
            out[mine] = k22_count(words[mine], spl_smem, ns)
            written[mine] += 1
    assert (written == 1).all(), "a row written twice or never"
    return out


def plan_of(words: list) -> tuple[bool, int]:
    """K22's plan for these columns, as the wrapper makes it (the output a
    fresh, aligned allocation)."""
    n = words[0].shape[0]
    return dist_plan.range_plan(n, [w.data_ptr() for w in words], [w.stride(0) for w in words],
                                torch.empty(max(n, 1), dtype=torch.int32).data_ptr())


def k22_case(g, nw: int, ns: int, n: int):
    """u32 key columns and sorted splitters: keys equal to a splitter, equal
    in the leading words only, and on both sides of 2^31 in every word."""
    pool = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, M32], np.uint64)
    spl = [np.sort(g.choice(pool, ns)).astype(np.uint32) for _ in range(nw)]
    spl_rows = np.stack(spl, 1) if ns else np.zeros((0, nw), np.uint32)
    order = np.lexsort(spl_rows.T[::-1]) if ns else np.arange(0)
    spl = [s[order] for s in (spl_rows.T if ns else spl)]
    words = [g.choice(pool, n).astype(np.uint32) for _ in range(nw)]
    if ns:  # rows equal to a splitter, and to one in all but the last word
        m = min(200, n)
        pick = g.integers(0, ns, m)
        for w, s in zip(words, spl):
            w[:m] = s[pick]
        words[-1][m // 2:m] ^= np.uint32(1)
    return words, spl


def check_k22(words_t: list, spl_t: list, want_vec: bool) -> np.ndarray:
    """The emulation under the wrapper's plan against the plain version and
    the JAX package's _lex_ge sum; the plan's path as expected."""
    plan = plan_of(words_t)
    assert plan[0] == want_vec
    words = [torch_to_u32(w) for w in words_t]
    spl = [torch_to_u32(s) for s in spl_t]
    emu = k22_emulate(words, spl, plan)
    np.testing.assert_array_equal(range_dest(words_t, spl_t).numpy(), emu)
    np.testing.assert_array_equal(range_dest_plain(words_t, spl_t).numpy(), emu)
    want = jdist._lex_ge([jnp.asarray(w) for w in words], [jnp.asarray(s) for s in spl])
    np.testing.assert_array_equal(np.asarray(want).sum(1), emu)
    return emu


@pytest.mark.parametrize("nw", [1, 2, 3, 4])
@pytest.mark.parametrize("ns", [0, 1, 3, 7])
def test_k22_emulation_matches_plain_and_jax(nw, ns):
    """Contiguous aligned columns (the vector path) at n = 600, a multiple
    of 4; keys equal to a splitter, equal in the leading words only, and on
    both sides of 2^31 in every word."""
    g = np.random.default_rng(nw * 10 + ns)
    words, spl = k22_case(g, nw, ns, 600)
    check_k22(list(map(t32, words)), list(map(t32, spl)), want_vec=True)
    want = jdist._lex_ge([jnp.asarray(w) for w in words], [jnp.asarray(s) for s in spl])
    got = tdist._lex_ge(list(map(t32, words)), list(map(t32, spl)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nw", [1, 2, 3, 4])
@pytest.mark.parametrize("tail", [0, 1, 2, 3])
@pytest.mark.parametrize("ns", [1, 3, 7])
def test_k22_vector_path_and_its_tail(nw, tail, ns):
    """n = 4q + tail rows across more than one block: the thread past the
    last whole group takes the tail row by row; n < 4 is all tail."""
    g = np.random.default_rng(100 * nw + 10 * tail + ns)
    for n in (4 * 300 + tail, tail):
        if n == 0:
            continue
        words, spl = k22_case(g, nw, ns, n)
        check_k22(list(map(t32, words)), list(map(t32, spl)), want_vec=True)


@pytest.mark.parametrize("nw", [1, 2, 4])
@pytest.mark.parametrize("ns", [0, 3, 7])
def test_k22_misaligned_contiguous_column_takes_the_scalar_path(nw, ns):
    """A contiguous column that starts at an odd row lies 4 bytes past a
    16-byte boundary: the scalar path, as one misaligned word among aligned
    ones sends every word there."""
    g = np.random.default_rng(nw + 7 * ns)
    words, spl = k22_case(g, nw, ns, 1203)
    cols = [t32(np.concatenate([[5], w]))[1:] for w in words]
    assert all(c.is_contiguous() and c.data_ptr() % 16 == 4 for c in cols)
    check_k22(cols, list(map(t32, spl)), want_vec=False)
    mixed = [t32(words[0])] + cols[1:]
    check_k22(mixed, list(map(t32, spl)), want_vec=nw == 1)


def test_k22_strided_key_words_and_refusals():
    """The key words as string columns of a row-major matrix (strided), with
    num contiguous beside them (field 3's key); strided splitters; the
    plan's grid and the wrapper's refusals."""
    g = np.random.default_rng(4)
    strw = t32(g.integers(0, 2**32, (2500, 8), dtype=np.uint64))
    spl = [t32(np.sort(g.integers(0, 2**32, 3, dtype=np.uint64))) for _ in range(4)]
    cols = [strw[:, 0], strw[:, 1]]
    assert not cols[0].is_contiguous()
    check_k22(cols, spl[:2], want_vec=False)
    num = t32(g.integers(0, 2**32, 2500, dtype=np.uint64))
    check_k22([num] + [strw[:, j] for j in range(3)], spl, want_vec=False)
    spl_mat = t32(np.stack([torch_to_u32(s) for s in spl], 1))  # [3, 4]: strided columns
    check_k22([num, num], [spl_mat[:, 0], spl_mat[:, 1]], want_vec=True)
    # the grid covers the rows once: rows a thread times threads a block
    for n, vec in ((1, True), (1024, True), (1025, True), (3000, False)):
        want = (vec, max(-(-n // (dist_plan.RANGE_THREADS * dist_plan.RANGE_ROWS)), 1))
        assert dist_plan.range_plan(n, [0], [1 if vec else 8], 0) == want
    assert dist_plan.range_plan(8, [16, 32], [1, 1], 8)[0] is False  # the output misaligned
    with pytest.raises(ValueError, match="K22"):
        range_dest([strw[:, 0]] * 5, [spl[0]] * 5)
    with pytest.raises(ValueError, match="K22"):  # the splitters past shared memory
        ns = dist_plan.SHARED_BYTES // 16 + 1
        range_dest([num] * 4, [torch.zeros(ns, dtype=torch.int32)] * 4)
    with pytest.raises(ValueError, match="K22"):
        dist_plan.check_splitters("range_dest", dist_plan.MAX_ROWS + 1, 1, 3)
    dist_plan.check_splitters("range_dest", dist_plan.MAX_ROWS, 4, dist_plan.SHARED_BYTES // 16)
    with pytest.raises(ValueError, match="one splitter column a key word"):
        range_dest(cols, spl[:1])


# ---------------------------------------------------------------------------
# K9's fill


@pytest.mark.parametrize("geometry", ["plan", "128x2", "64x1"])
@pytest.mark.parametrize("fill", [0, M32, 0x12345678])
def test_k9_fill_emulation_matches_plain_and_jax(fill, geometry):
    """The overlap join's key-only pack: slots, each row's slot, counts and
    overflow, the dead slots holding the fill (JAX: 0xFFFFFFFF)."""
    g = np.random.default_rng(fill % 97)
    n, nparts, cap, count = 700, 5, 120, 640
    dest = g.integers(0, nparts, n).astype(np.uint32)
    pay = [g.integers(0, 2**32, n, dtype=np.uint64) for _ in range(2)]
    span, warps = GEOMETRIES[geometry]
    emu = emulate_stage(dest, None, count, nparts, cap, pay, "slots", span, warps, fill=fill)
    got = stage_to_cells(t32(dest), None, nparts, cap, [t32(p) for p in pay], "slots",
                         count=count, fill=fill)
    for a, b in zip(got[0], emu[0]):
        np.testing.assert_array_equal(torch_to_u32(a), b)
    np.testing.assert_array_equal(got[1].numpy(), emu[1])
    np.testing.assert_array_equal(got[2].numpy(), emu[2])
    assert int(got[3]) == emu[3] > 0
    if fill == M32:
        want = joverlap._partition_words_to_slots([jnp.asarray(p.astype(np.uint32)) for p in pay],
                                                  jnp.int32(count), jnp.asarray(dest), nparts,
                                                  cap)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(torch_to_u32(a), np.asarray(b))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[1]))
    with pytest.raises(ValueError, match="fill"):
        stage_to_cells(t32(dest), None, nparts, cap, [], "none", fill=1 << 32)
