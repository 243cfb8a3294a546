"""The launch plans of K6 (adjacent-key equality) and K7's gather form
(un-permute) on the CPU, and the tiled join's gather route against JAX.

``kernels/perm_plan.py`` holds what the wrappers hand to the CUDA kernels:
K6's rows a lane, the grouping of key words into runs of adjacent columns
and the vector widths each run is read with, the refusals; the gather's rows a
thread and grid, and the multiplier that divides a slot by the cell
capacity.  Here numpy emulations run the kernels' algorithms with it:

- K6: a warp owns 32 R sorted rows, warp-striped (lane L holds rows L, L
  + 32, ...); every lane loads its rows' words a stage at a time, a row's
  words only while its own compare or its successor's is open (a word not
  loaded keeps the value of the stage before), the predecessor of a row
  comes from the lane below by a shuffle (lane 0's from lane 31 of the step
  before), lane 0 reads the one before the warp; the compares run stage by
  stage.  Held against ``adj_equal_plain`` and the JAX package's
  ``rows_equal_on_field(batch, f, perm[:-1], perm[1:])`` with its leading
  False, for fields 0-3, through a permutation and in place.
- K7: the grid's walk covers every row once; the gather's slot division by
  the host's multiplier; the gather (plain) against ``unpermute_plain(si,
  ·)`` on ``stage_to_cells_plain``'s outputs over the count forms and cell
  layouts.
- The port's tiled ``_tiled_matched_mult``, ``hash_join_count`` and
  ``hash_join``, which stage the probe side with the "slots" row map and
  gather the counts, against the JAX package's at fields 0-3.

Inputs come from seeded numpy generators; every value is an integer, so
every comparison is exact (tolerance 0).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.config import EngineConfig as JConfig
from database_technology_algorithms_tpu.ops import keys as jkeys
from database_technology_algorithms_tpu_torch.batch import torch_to_u32
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.kernels import perm_plan as plan
from database_technology_algorithms_tpu_torch.kernels.adj_equal import adj_equal, adj_equal_plain
from database_technology_algorithms_tpu_torch.kernels.stage_cells import stage_to_cells_plain
from database_technology_algorithms_tpu_torch.kernels.unpermute import (
    unpermute, unpermute_gather, unpermute_gather_plain, unpermute_plain)
from database_technology_algorithms_tpu_torch.ops import hash_join as thash
from database_technology_algorithms_tpu_torch.ops import keys as tkeys
from test_torch_operators import assert_same_batch, both_batches, make_cols

jhash = importlib.import_module("database_technology_algorithms_tpu.ops.hash_join")
FIELDS = [0, 1, 2, 3]
LANES = plan.LANES
CHUNK = plan.CHUNK_WORDS
BASE = 1 << 20  # a 16-byte aligned address for the plans' pointer arithmetic


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# K6's plan: runs of adjacent words and their vectors


def matrix_words(k: int, cols, offset: int = 0, stride: int | None = None):
    """(ptrs, strides) of columns `cols` of a row-major [N, k] u32 matrix
    whose first element lies `offset` bytes past BASE."""
    stride = k if stride is None else stride
    return [BASE + offset + 4 * j for j in cols], [stride] * len(cols)


@pytest.mark.parametrize("k,cols,widths", [
    (2, [0, 1], [2, 0]),  # field 2 at K = 2: one 8-byte load
    (4, [0, 1, 2, 3], [4, 0, 0, 0]),  # K = 4: one 16-byte load
    (3, [0, 1, 2], [1, 1, 1]),  # a row stride of 3 words aligns no vector
    (8, list(range(8)), [4, 0, 0, 0, 4, 0, 0, 0]),
    (8, list(range(6)), [4, 0, 0, 0, 2, 0]),
    (6, [1, 2, 3, 4], [1, 2, 0, 1]),  # a view 4 bytes in: 4-byte loads to the next 8 bytes
    (4, [1, 2], [1, 1]),  # columns 1, 2: 4 bytes past 16 B, then 8 past
    (4, [2, 3], [2, 0]),
    (4, [0, 2], [1, 1]),  # not adjacent: two runs
    (4, [3, 2], [1, 1]),  # adjacent the wrong way round
    (8, [1, 2, 3, 4, 5, 6, 7], [1, 2, 0, 1, 1, 2, 0]),
])
def test_word_widths_cut_runs_into_aligned_vectors(k, cols, widths):
    ptrs, strides = matrix_words(k, cols)
    assert plan.word_widths(ptrs, strides) == widths


def test_key_stages_of_field_3_keys():
    """num, then strw's words: num is a stage of its own (its words lie
    apart from strw's), and the strw run is cut into stages of 4 words from
    its own start, so an aligned strw loads as 16-byte vectors."""
    for k, stages, widths in ((2, [0, 1, 3], [1, 2, 0]), (4, [0, 1, 5], [1, 4, 0, 0, 0]),
                              (32, [0] + list(range(1, 34, 4)), [1] + [4, 0, 0, 0] * 8)):
        ptrs, strides = matrix_words(k, range(k), offset=64)
        ptrs, strides = [BASE - 4096] + ptrs, [1] + strides
        assert plan.key_runs(ptrs, strides) == [(0, 1), (1, k)]
        assert plan.key_stages(ptrs, strides) == stages
        assert plan.word_widths(ptrs, strides) == widths


def test_word_widths_never_join_words_that_lie_apart():
    """Stages given from outside (4 words of the key wherever they lie)
    still read words of different runs apart."""
    ptrs, strides = matrix_words(4, range(4), offset=64)
    ptrs, strides = [BASE - 4096] + ptrs, [1] + strides
    assert plan.word_widths(ptrs, strides, [0, 4, 5]) == [1, 2, 0, 1, 1]


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 32])
def test_word_widths_read_every_word_once_inside_its_stage(k, offset):
    ptrs, strides = matrix_words(k, range(k), offset=offset)
    stages = plan.key_stages(ptrs, strides)
    assert stages == list(range(0, k, CHUNK)) + [k]
    widths = plan.word_widths(ptrs, strides)
    covered = []
    for j, v in enumerate(widths):
        if v:
            assert v in plan.VEC_WORDS
            end = min(x for x in stages if x > j)
            assert j + v <= end  # no vector leaves its stage
            assert ptrs[j] % (4 * v) == 0 and strides[j] % v == 0
            covered += list(range(j, j + v))
    assert covered == list(range(k))


def test_key_plan_of_a_batch_matches_its_layout():
    """The key words of a torch batch: strw's columns are one run; at K = 2
    and K = 4 the batch's (aligned) allocation reads them as one vector."""
    for strings, k in (("short", 2), ("tie", 4)):
        _, tb = both_batches(make_cols(64, seed=3, strings=strings))
        assert tb.str_words == k
        words = tkeys.key_words(tb, 2)
        assert plan.key_runs([w.data_ptr() for w in words],
                             [w.stride(0) for w in words]) == [(0, k)]
        patterns, stages = plan.key_plan(words)
        assert stages == [0, k]
        if tb.strw.data_ptr() % 16 == 0:
            assert patterns == [k]  # one vector of k words
        patterns, stages = plan.key_plan(tkeys.key_words(tb, 3))
        assert patterns[0] == 0x1 and stages == [0, 1, k + 1]


# the twelve stage patterns the kernel is built for (DBT_STAGE_PATTERNS)
KERNEL_PATTERNS = {0x1, 0x2, 0x11, 0x4, 0x12, 0x21, 0x111, 0x22, 0x112, 0x121, 0x211, 0x1111}


@pytest.mark.parametrize("widths,stages,patterns", [
    ([1], [0, 1], [0x1]),
    ([2, 0], [0, 2], [0x2]),
    ([4, 0, 0, 0], [0, 4], [0x4]),
    ([1, 2, 0, 1], [0, 4], [0x121]),
    ([1, 2, 0], [0, 1, 3], [0x1, 0x2]),
    ([1, 1, 1, 1, 2, 0], [0, 4, 6], [0x1111, 0x2]),
])
def test_stage_patterns_pack_the_vectors(widths, stages, patterns):
    assert plan.stage_patterns(widths, stages) == patterns


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 32, 40])
def test_every_planned_pattern_is_built(k, offset):
    for stride in (k, k + 1, 2 * k):
        ptrs, strides = matrix_words(stride, range(k), offset=offset, stride=stride)
        stages = plan.key_stages(ptrs, strides)
        patterns = plan.stage_patterns(plan.word_widths(ptrs, strides), stages)
        assert set(patterns) <= KERNEL_PATTERNS
        for first, end, pattern in zip(stages[:-1], stages[1:], patterns):
            digits = [(pattern >> (4 * q)) & 0xF for q in range(4)]
            assert sum(digits) == end - first


def test_k6_refusals():
    plan.check_adj("k", plan.MAX_ROWS, plan.MAX_KEY_WORDS)
    for n, m in ((10, 0), (10, plan.MAX_KEY_WORDS + 1), (plan.MAX_ROWS + 1, 2)):
        with pytest.raises(ValueError):
            plan.check_adj("k", n, m)
    assert plan.ADJ_ROWS in plan.ADJ_ROW_CHOICES


# ---------------------------------------------------------------------------
# K6's warp layout, emulated


def chunk_stages(m: int) -> list[int]:
    """Stages of a key whose words all lie together: 4 words at a time."""
    return list(range(0, m, CHUNK)) + [m]


def emulate_adj(cols: np.ndarray, perm, rows: int, stages: list[int]) -> np.ndarray:
    """K6 as the card runs it, for u32 key columns `cols` [n, m], a
    permutation (None: in place), `rows` rows a lane and the plan's
    `stages`: warp-striped rows, a stage's words loaded where a row's own
    compare or its successor's is open (a word not loaded keeps the value
    of the stage before), predecessors by a shuffle from the lane below
    (lane 0's from lane 31 of the step before, or its own read before the
    warp)."""
    n, m = cols.shape
    if n == 0:
        return np.zeros(0, bool)
    warps = -(-n // (LANES * rows))
    j = np.arange(warps * rows * LANES).reshape(warps, rows, LANES)  # warp, step, lane
    valid = j < n
    order = np.arange(n) if perm is None else np.asarray(perm, np.int64)
    a = np.where(valid, order[np.minimum(j, n - 1)], 0)
    outside = j[:, 0, 0] > 0  # lane 0 of a warp past the first
    a_prev = np.where(outside, order[np.maximum(j[:, 0, 0] - 1, 0)], 0)
    e = valid & (j > 0)
    w = np.zeros((warps, rows, LANES, CHUNK), np.uint32)  # the registers, kept between stages
    wp = np.zeros((warps, LANES, CHUNK), np.uint32)
    multi = len(stages) > 2
    for s in range(len(stages) - 1 if multi else 1):
        first, words = stages[s], stages[s + 1] - stages[s]
        if multi:
            succ = np.zeros_like(e)  # (r, lane + 1), and for lane 31 (r + 1, 0)
            succ[:, :, :-1] = e[:, :, 1:]
            succ[:, :-1, -1] = e[:, 1:, 0]
            need = e | succ
        else:
            need = np.ones_like(e)
        load = need & valid
        w[..., :words][load] = cols[a[load], first:first + words]
        own = outside & e[:, 0, 0]
        wp[:, 0, :words][own] = cols[a_prev[own], first:first + words]
        for r in range(rows):
            x = np.roll(w[:, r], 1, axis=1)  # lane L gets lane L - 1's row (lane 0: lane 31's)
            pred = x.copy()
            pred[:, 0] = wp[:, 0]
            wp[:, 0] = x[:, 0]
            e[:, r] &= (w[:, r, :, :words] == pred[..., :words]).all(-1)
    return e.reshape(-1)[:n]


def jax_adjacent(jb, field: int, perm: np.ndarray) -> np.ndarray:
    """The JAX package's rows_equal_on_field over (perm[:-1], perm[1:]) with
    its leading False."""
    if perm.shape[0] == 0:
        return np.zeros(0, bool)
    p = jnp.asarray(perm.astype(np.int32))
    eq = np.asarray(jkeys.rows_equal_on_field(jb, field, p[:-1], p[1:]))
    return np.concatenate([[False], eq])


@pytest.mark.parametrize("rows", plan.ADJ_ROW_CHOICES)
@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("strings", ["tie", "short"])
def test_adj_emulation_matches_plain_and_jax(field, strings, rows):
    """At the sorted order (runs of equal keys), a random order and in
    place, on a size that leaves a warp and a lane part-filled."""
    n = 32 * rows * 3 + 5
    cols = make_cols(n, seed=40 + field, strings=strings)
    jb, tb = both_batches(cols)
    words = tkeys.key_words(tb, field)
    stages = plan.key_plan(words)[1]
    assert len(stages) - 1 == (2 if field == 3 else 1)  # field 3: num, then strw
    mat = np.stack([torch_to_u32(w) for w in words], axis=1)
    g = np.random.default_rng(field)
    sorted_perm = np.lexsort(mat.T[::-1]).astype(np.int32)
    for perm in (sorted_perm, g.permutation(n).astype(np.int32), None):
        tp = None if perm is None else torch.from_numpy(perm)
        want = jax_adjacent(jb, field, np.arange(n) if perm is None else perm)
        np.testing.assert_array_equal(adj_equal_plain(words, tp).numpy(), want)
        np.testing.assert_array_equal(emulate_adj(mat, perm, rows, stages), want)
    assert emulate_adj(mat, sorted_perm, rows, stages).sum() > 0  # some runs of equal keys


@pytest.mark.parametrize("rows", plan.ADJ_ROW_CHOICES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 33, 40])
def test_adj_emulation_long_keys_and_edges(m, rows):
    """Keys of 1-40 words whose ties reach any chunk (a few values a word),
    all equal and all distinct, at a lane's, a warp's and a block's edges."""
    g = np.random.default_rng(m * 10 + rows)
    block = plan.THREADS * rows
    for n in (0, 1, 2, rows, 31, 32 * rows - 1, 32 * rows, 32 * rows + 1, block + 1):
        few = (g.integers(0, 2, size=(n, m)) << 31).astype(np.uint32) | g.integers(
            0, 2, size=(n, m)).astype(np.uint32)
        cases = {"few": few, "equal": np.zeros((n, m), np.uint32),
                 "distinct": np.concatenate([few[:, :-1], np.arange(n, dtype=np.uint32)[:, None]],
                                            axis=1)}
        for what, mat in cases.items():
            words = [t32(mat[:, j]) for j in range(m)]
            for perm in (np.lexsort(mat.T[::-1]).astype(np.int32) if n else None,
                         g.permutation(n).astype(np.int32), None):
                tp = None if perm is None else torch.from_numpy(perm)
                want = adj_equal_plain(words, tp).numpy()
                for stages in (chunk_stages(m), list(range(m + 1))):
                    np.testing.assert_array_equal(emulate_adj(mat, perm, rows, stages), want,
                                                  err_msg=f"n={n} {what} {stages}")
                np.testing.assert_array_equal(adj_equal(words, tp).numpy(), want)


def test_adj_emulation_needs_the_successors_words():
    """A row differs from its predecessor in the first stage but its
    successor ties with it through every stage: the row's later stages must
    still be loaded, for a successor in the next lane and, at lane 31, in
    lane 0 of the next step."""
    rows, m = 2, 9
    for row in (1, 31):
        mat = np.zeros((64, m), np.uint32)
        mat[row, 0] = 1  # the row differs from its predecessor in stage 0
        mat[row, 4:] = 9  # and holds other words in the later stages
        mat[row + 1] = mat[row]  # its successor equals it in every stage
        mat[row + 2:] = 7
        want = adj_equal_plain([t32(mat[:, j]) for j in range(m)], None).numpy()
        assert want[row + 1] and not want[row]
        for stages in (chunk_stages(m), list(range(m + 1))):
            np.testing.assert_array_equal(emulate_adj(mat, None, rows, stages), want)


# ---------------------------------------------------------------------------
# K7's plan: the grid's walk and the slot division


@pytest.mark.parametrize("waves", [0, 1, 2])
@pytest.mark.parametrize("rows", [1, 4, 8, 16])
def test_k7_grid_walk_covers_every_row_once(rows, waves):
    sms = 3
    for n in (0, 1, plan.THREADS * rows - 1, plan.THREADS * rows + 1,
              sms * plan.BLOCKS_PER_SM * plan.THREADS * rows * 2 + 7):
        blocks = plan.blocks(n, rows, waves, sms=sms)
        if waves:
            assert blocks <= waves * sms * plan.BLOCKS_PER_SM
        else:  # no limit: the grid covers the rows
            assert blocks == max(-(-n // (plan.THREADS * rows)), 1)
        stride = blocks * plan.THREADS * rows
        seen = np.zeros(n, np.int64)
        for b in range(blocks):
            for t in range(plan.THREADS):
                for i0 in range((b * plan.THREADS + t) * rows, n, stride):
                    seen[i0: min(i0 + rows, n)] += 1
        assert (seen == 1).all()


def test_k7_plan_choices_are_built():
    assert plan.ADJ_ROWS in plan.ADJ_ROW_CHOICES
    assert plan.GATHER_ROWS in plan.GATHER_ROW_CHOICES
    # above one row a thread, a thread's slots fill whole 16-byte vectors
    assert all(r == 1 or r % 4 == 0 for r in plan.GATHER_ROW_CHOICES)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 9, 1000, 8792, 17584, (1 << 20) + 1, (1 << 30) - 3,
                               (1 << 31) - 1])
def test_div_magic_divides_every_31_bit_slot(d):
    mult, shift = plan.div_magic(d)
    assert 31 <= shift <= 62 and mult < 1 << 33
    g = np.random.default_rng(d % 1000)
    near = [0, 1, d - 1, d, d + 1, 2 * d - 1, 2 * d, (1 << 31) - 1, (1 << 31) - 2]
    for k in ((1 << 31) - 1) // d, ((1 << 31) - 1) // d - 1:
        near += [k * d - 1, k * d, k * d + 1]
    for s in near + [int(x) for x in g.integers(0, 1 << 31, size=2000)]:
        if 0 <= s < 1 << 31:
            assert (s * mult) >> shift == s // d, (s, d)
            assert (s * mult) < 1 << 64


def test_k7_refusals():
    for d in (0, 1 << 31):
        with pytest.raises(ValueError):
            plan.div_magic(d)
    with pytest.raises(ValueError):
        plan.check_gather("g", 10, 1 << 16, 1 << 16, 10)
    with pytest.raises(ValueError):
        plan.check_gather("g", 10, 0, 8, 10)
    with pytest.raises(ValueError):
        plan.check_rows("s", plan.MAX_ROWS + 1)
    with pytest.raises(TypeError):
        unpermute_gather(torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 4)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        unpermute_gather(torch.empty(8, dtype=torch.int32, device=meta),
                         torch.empty(8, dtype=torch.int32, device=meta),
                         torch.empty(2, dtype=torch.int32, device=meta), 4)


# ---------------------------------------------------------------------------
# K7's gather against the scatter through the staging permutation


def emulate_gather(slots, vals, first, cap, count) -> np.ndarray:
    """The gather kernel's arithmetic: the slot divided by the host's
    multiplier, rows past the live count and slots past the cells give 0."""
    mult, shift = plan.div_magic(cap)
    n, nslots = len(slots), len(first) * cap
    live = n if count is None else min(max(int(count), 0), n)
    out = np.zeros(n, np.int64)
    for i in range(live):
        s = int(slots[i]) & 0xFFFFFFFF
        if s < nslots:
            cell = (s * mult) >> shift
            at = int(first[cell]) + s - cell * cap
            if 0 <= at < len(vals):
                out[i] = vals[at]
    return out


COUNT_FORMS = ["none", "int", "tensor", "zero", "past_n"]


@pytest.mark.parametrize("count_form", COUNT_FORMS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nparts,overflows", [(1, False), (2, False), (16, False), (64, False),
                                              (16, True), (64, True)])
def test_gather_equals_the_scatter_through_si(nparts, overflows, masked, count_form):
    g = np.random.default_rng(nparts * 7 + overflows)
    n = 1500
    dest = t32(g.integers(0, nparts, size=n))
    active = torch.from_numpy(g.random(n) < 0.7) if masked else None
    count = {"none": None, "int": 1000, "tensor": torch.tensor(900, dtype=torch.int32),
             "zero": 0, "past_n": n + 3}[count_form]
    even = -(-n // nparts)
    cap = max(even // 3, 1) if overflows else 2 * even
    word = t32(g.integers(0, 2**32, size=n, dtype=np.uint64))
    _, cnt, slots, ovf = stage_to_cells_plain(dest, active, nparts, cap, [word], "slots", count)
    _, cnt_si, si, ovf_si = stage_to_cells_plain(dest, active, nparts, cap, [word], "si", count)
    assert torch.equal(cnt, cnt_si) and int(ovf) == int(ovf_si)
    assert (int(ovf) > 0) == overflows or count_form == "zero"
    first = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    staged = int(cnt.sum())
    vals = t32(g.integers(1, 9, size=n))
    got = unpermute_gather(slots, vals, first, cap, count)  # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), emulate_gather(
        slots.numpy(), vals.numpy(), first.numpy(), cap,
        None if count is None else int(count)))
    m = nparts * cap
    assert not got[slots >= m].any()  # unstaged rows, overflowed ones included, carry 0
    if not overflows:
        in_slot_order = torch.where(torch.arange(n) < staged, vals, 0)
        np.testing.assert_array_equal(got.numpy(), unpermute_plain(si, in_slot_order, 0, n).numpy())
        np.testing.assert_array_equal(got.numpy(), unpermute(si, in_slot_order).numpy())


def test_gather_of_nothing():
    empty = torch.zeros(0, dtype=torch.int32)
    assert unpermute_gather_plain(empty, empty, torch.zeros(2, dtype=torch.int32), 4).shape == (0,)
    slots = torch.tensor([0, 8, 3], dtype=torch.int32)
    got = unpermute_gather_plain(slots, empty, torch.zeros(2, dtype=torch.int32), 4)
    assert got.tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# the tiled join on the "slots" route against JAX


def join_pair(seed: int, strings: str):
    build = make_cols(600, seed=seed, strings=strings)
    probe = make_cols(800, seed=seed + 1, strings=strings)
    return both_batches(build), both_batches(probe)


@pytest.mark.parametrize("counts", [False, True], ids=["all_rows", "counts"])
@pytest.mark.parametrize("mem_rows", [128, 1024])
@pytest.mark.parametrize("field", FIELDS)
def test_tiled_matched_mult_matches_jax(field, mem_rows, counts, monkeypatch):
    (jb, tb), (jp, tp) = join_pair(31, "tie")
    jkw = dict(build_count=jnp.int32(450), probe_count=jnp.int32(700)) if counts else {}
    tkw = dict(build_count=torch.tensor(450, dtype=torch.int32),
               probe_count=torch.tensor(700, dtype=torch.int32)) if counts else {}
    calls = []
    staged = thash.stage_to_cells

    def record(*args, **kw):
        calls.append(kw.get("row_map", args[5] if len(args) > 5 else "slots"))
        return staged(*args, **kw)

    def no_scatter(*args, **kw):
        raise AssertionError("the tiled join must not scatter")

    monkeypatch.setattr(thash, "stage_to_cells", record)
    monkeypatch.setattr(thash, "unpermute", no_scatter)
    for cap_mult in (1, 4):
        want = jhash._tiled_matched_mult(jb, jp, field, JConfig(mem_rows=mem_rows),
                                         jkw.get("build_count"), jkw.get("probe_count"), cap_mult)
        got = thash._tiled_matched_mult(tb, tp, field, TConfig(mem_rows=mem_rows),
                                        tkw.get("build_count"), tkw.get("probe_count"), cap_mult)
        assert int(got[2]) == int(want[2])
        if int(want[2]) == 0:  # an attempt that overflowed is discarded by both
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(torch_to_u32(got[1]), np.asarray(want[1]))
            assert got[0].any()
    assert calls == ["none", "slots"] * 2


@pytest.mark.parametrize("mem_rows", [128, 1024])
@pytest.mark.parametrize("field", FIELDS)
def test_tiled_join_public_forms_match_jax(field, mem_rows):
    (jb, tb), (jp, tp) = join_pair(51, "short")
    want = jhash.hash_join_count(jb, jp, field, JConfig(mem_rows=mem_rows))
    got = thash.hash_join_count(tb, tp, field, TConfig(mem_rows=mem_rows))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(torch_to_u32(got[1]), np.asarray(want[1]).astype(np.uint32))
    assert int(got[2]) == int(want[2]) > 0
    want_b, want_n = jhash.hash_join(jb, jp, field, JConfig(mem_rows=mem_rows))
    got_b, got_n = thash.hash_join(tb, tp, field, TConfig(mem_rows=mem_rows))
    assert int(got_n) == int(want_n)
    assert_same_batch(got_b, want_b)
