"""The row-move engine of K4 (record gather) and K12 (row move) on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there); what the CPU can check is the launch plan the
wrappers hand them (``kernels/rowmove_plan.py``: the access width from the
row width and the pointers' alignment, the rows a block owns) and the plain
versions with the live count the kernels take: ``take_fill_plain`` against
the JAX package's ``RecordBatch.take_fill`` of ``where(arange(m) < count,
idx, n)`` (an empty source, which ``jnp.take`` refuses, against zero rows),
``row_move_plain`` against a numpy loop.  Inputs come from a
seeded ``np.random.default_rng`` made in each test; every value is an
integer, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.kernels import rowmove_plan as plan
from database_technology_algorithms_tpu_torch.kernels.row_move import row_move, row_move_plain
from database_technology_algorithms_tpu_torch.kernels.take_fill import take_fill_plain

WIDTHS = [1, 2, 3, 4, 5, 8, 30, 32, 36]
OFFSETS = [0, 4, 8, 12]  # bytes past a 16-byte boundary
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the access width


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("width", WIDTHS)
def test_access_width_is_the_widest_that_fits(width, offset):
    aligned = 1 << 20
    for ptrs in ((aligned + offset, aligned), (aligned, aligned + offset)):
        v = plan.access_words(width, *ptrs)
        assert v in (1, 2, 4)
        assert width % v == 0 and all(p % (4 * v) == 0 for p in ptrs)
        wider = [w for w in (2, 4) if w > v]
        assert not any(width % w == 0 and all(p % (4 * w) == 0 for p in ptrs) for w in wider)


@pytest.mark.parametrize("width, offset, want", [
    (2, 0, 2),    # the main path's string words: 8 bytes a row
    (2, 8, 2),    # an odd row offset of the same
    (36, 0, 4),   # the probe's rows, 144 bytes
    (36, 4, 1),
    (36, 8, 2),
    (5, 0, 1),    # "sort2d" stage B
    (30, 0, 2),
    (32, 12, 1),
    (4, 8, 2),
    (3, 0, 1),
    (1, 0, 1),
])
def test_access_width_at_known_shapes(width, offset, want):
    assert plan.access_words(width, (1 << 20) + offset, 1 << 20) == want


@pytest.mark.parametrize("width", WIDTHS)
def test_access_width_of_offset_views(width):
    """Row slices are views with offsets (a batch's slice, a chunk of an
    index): the width follows the view's own pointer."""
    n = 16
    flat = torch.zeros(n * width + 3, dtype=torch.int32)
    out = torch.zeros((n, width), dtype=torch.int32)
    for words in range(4):
        view = flat[words: words + n * width].view(n, width)
        assert view.data_ptr() - flat.data_ptr() == 4 * words
        v = plan.access_words(width, view.data_ptr(), out.data_ptr())
        assert width % v == 0 and view.data_ptr() % (4 * v) == 0
        if flat.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0:
            fits = [w for w in (4, 2, 1) if width % w == 0 and (4 * words) % (4 * w) == 0]
            assert v == fits[0]


def test_access_width_refuses_unaligned_words():
    with pytest.raises(ValueError, match="aligned"):
        plan.access_words(4, (1 << 20) + 2)


# ---------------------------------------------------------------------------
# the rows a block owns and the split of its vectors


IN_L2, BEYOND_L2 = 40 * 10**6, 300 * 10**6  # bytes a call touches


@pytest.mark.parametrize("footprint", [IN_L2, BEYOND_L2])
@pytest.mark.parametrize("row_vectors", [0, 1, 2, 3, 5, 9, 16, 36, 100, 4096, 5000, 65535])
def test_block_rows(row_vectors, footprint):
    rows = plan.block_rows(row_vectors, footprint)
    assert 1 <= rows <= plan.MAX_BLOCK_ROWS and rows & (rows - 1) == 0
    assert rows * row_vectors * row_vectors < 1 << 32
    in_l2 = footprint <= plan.L2_BYTES
    vectors = plan.L2_VECTORS if in_l2 else plan.DRAM_VECTORS
    least = 1 if in_l2 else plan.MIN_DRAM_ROWS
    if rows > least:
        assert rows * row_vectors <= vectors
    if rows < plan.MAX_BLOCK_ROWS and rows * row_vectors * row_vectors * 4 < 1 << 32:
        assert 2 * rows * row_vectors > vectors


@pytest.mark.parametrize("row_vectors, footprint, want", [
    (1, IN_L2, 1024),     # K4 at the staged shape: 2 string words, one 8-byte vector
    (5, IN_L2, 1024),     # K12 at "sort2d" stage B, 1M rows of 5 words
    (9, BEYOND_L2, 64),   # K12's probe, 2^20 rows of 36 words
    (5, BEYOND_L2, 128),
    (1, BEYOND_L2, 1024),  # K4 at the over-budget route's chunk
])
def test_block_rows_at_known_shapes(row_vectors, footprint, want):
    assert plan.block_rows(row_vectors, footprint) == want


@pytest.mark.parametrize("footprint", [IN_L2, BEYOND_L2])
@pytest.mark.parametrize("d", [2, 3, 5, 7, 9, 18, 36, 1000, 4097, 65535])
def test_block_split_is_exact(d, footprint):
    """csrc/rowmove.cuh splits a block's vector number e into (e / d, e % d)
    by umulhi(e, floor((2^32 - 1) / d) + 1), exact for e * d < 2^32; every e
    a block of plan.block_rows rows reaches is held here."""
    magic = (0xFFFFFFFF // d) + 1
    total = plan.block_rows(d, footprint) * d
    assert total * d < 1 << 32
    e = np.arange(total, dtype=np.uint64)
    np.testing.assert_array_equal((e * np.uint64(magic)) >> np.uint64(32), e // np.uint64(d))


def test_shapes_beyond_32_bit_addressing_are_refused():
    with pytest.raises(ValueError, match="2\\^31"):
        plan.check_shape("take_fill", 1 << 31, 4, 1)
    with pytest.raises(ValueError, match="multiply-high"):
        plan.check_shape("row_move", 4, 4, 1 << 16)
    plan.check_shape("row_move", (1 << 31) - 1, 16 << 20, plan.MAX_ROW_VECTORS)


def test_count_arg():
    dev = CPU
    assert plan.count_arg(None, 10, dev) == (None, 10)
    assert plan.count_arg(4, 10, dev) == (None, 4)
    assert plan.count_arg(-3, 10, dev) == (None, 0)
    assert plan.count_arg(99, 10, dev) == (None, 10)
    t, host = plan.count_arg(torch.tensor([7], dtype=torch.int64), 10, dev)
    assert t.dtype == torch.int32 and t.shape == () and int(t) == 7 and host == 10
    with pytest.raises(ValueError, match="one value"):
        plan.count_arg(torch.zeros(2, dtype=torch.int32), 10, dev)


# ---------------------------------------------------------------------------
# K4's plain version with and without the live count, against JAX


def source_columns(g, n: int, k: int) -> dict:
    return {"recid": g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
            "num": g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
            "strw": g.integers(0, 2**32, size=(n, k), dtype=np.uint64).astype(np.uint32),
            "valid": g.random(n) < 0.8}


def indices(g, case: str, n: int, m: int) -> np.ndarray:
    if case == "mixed":  # negative, in range and out of range on both sides
        return g.integers(-2 * n - 3, 2 * n + 3, size=m).astype(np.int32)
    if case == "negative":  # every index counts from the end, some past -n
        return g.integers(-n - 2, 0, size=m).astype(np.int32)
    if case == "all fill":
        return np.where(g.random(m) < 0.5, n, -n - 1).astype(np.int32)
    return g.integers(0, max(n, 1), size=m).astype(np.int32)  # "in range"


CASES = {  # case -> (n, m)
    "mixed": (200, 300), "negative": (200, 150), "in range": (150, 400),
    "all fill": (120, 90), "m = 0": (50, 0), "n = 0": (0, 40),
}


COUNTS = [None, "int", "tensor", "past m", "negative"]


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("k", [2, 4, 8, 16, 32])
def test_take_fill_plain_matches_jax(k, case, count):
    n, m = CASES[case]
    g = np.random.default_rng(k * 100 + list(CASES).index(case) * 10 + COUNTS.index(count))
    cols = source_columns(g, n, k)
    idx = indices(g, "in range" if case in ("m = 0", "n = 0") else case, n, m)
    cnt = {None: None, "int": m // 3, "tensor": torch.tensor(m // 2, dtype=torch.int32),
           "past m": m + 7, "negative": -2}[count]
    jb = JBatch(recid=jnp.asarray(cols["recid"]), num=jnp.asarray(cols["num"]),
                strw=jnp.asarray(cols["strw"]), valid=jnp.asarray(cols["valid"]))
    jidx = jnp.asarray(idx)
    if cnt is not None:  # what the JAX package computes for a live count
        jidx = jnp.where(jnp.arange(m) < int(cnt), jidx, n)
    if n:
        want = jb.take_fill(jidx)
    else:  # jnp.take refuses an empty source; every row is a fill row
        want = JBatch(recid=np.zeros(m, np.uint32), num=np.zeros(m, np.uint32),
                      strw=np.zeros((m, k), np.uint32), valid=np.zeros(m, bool))
    tcols = (u32_to_torch(cols["recid"], CPU), u32_to_torch(cols["num"], CPU),
             u32_to_torch(cols["strw"], CPU), torch.from_numpy(cols["valid"]))
    got = take_fill_plain(*tcols, torch.from_numpy(idx), cnt)
    np.testing.assert_array_equal(torch_to_u32(got[0]), np.asarray(want.recid))
    np.testing.assert_array_equal(torch_to_u32(got[1]), np.asarray(want.num))
    np.testing.assert_array_equal(torch_to_u32(got[2]), np.asarray(want.strw))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want.valid))
    # the batch method passes the count on; an offset view reads its own rows
    tb = TBatch(*tcols)
    via = tb.take_fill(torch.from_numpy(idx), count=cnt)
    np.testing.assert_array_equal(via.strw.numpy(), got[2].numpy())
    if n > 1:
        sub = TBatch(tcols[0][1:], tcols[1][1:], tcols[2][1:], tcols[3][1:])
        want_sub = JBatch(recid=jb.recid[1:], num=jb.num[1:], strw=jb.strw[1:],
                          valid=jb.valid[1:]).take_fill(jnp.asarray(idx))
        got_sub = sub.take_fill(torch.from_numpy(idx))
        np.testing.assert_array_equal(torch_to_u32(got_sub.strw), np.asarray(want_sub.strw))
        np.testing.assert_array_equal(got_sub.valid.numpy(), np.asarray(want_sub.valid))


# ---------------------------------------------------------------------------
# K12's plain version against numpy


def numpy_row_move(x: np.ndarray, slot: np.ndarray, tile: int, load: bool, count=None):
    """Tile by tile, row by row, as the Pallas probe states it."""
    n = x.shape[0]
    out = np.zeros_like(x)
    live = n if count is None else int(count)
    for t0 in range(0, n, tile):
        size = min(tile, n - t0)
        for j in range(size):
            s = int(slot[t0 + j])
            if not 0 <= s < size:
                continue
            if load and t0 + j < live:
                out[t0 + j] = x[t0 + s]
            elif not load:
                out[t0 + s] = x[t0 + j]
    return out


@pytest.mark.parametrize("count", [None, 0, "half", "tensor", "past n"])
@pytest.mark.parametrize("tile", [1, 7, 64, "n"])
@pytest.mark.parametrize("w", [1, 3, 5, 36])
def test_row_move_plain_load_matches_numpy(w, tile, count):
    g = np.random.default_rng(w * 1000 + (0 if tile == "n" else tile))
    n = 203
    tile = n if tile == "n" else tile
    x = g.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)
    slot = g.integers(-3, tile + 3, size=n).astype(np.int32)
    cnt = {None: None, 0: 0, "half": n // 2, "tensor": torch.tensor(n // 3, dtype=torch.int32),
           "past n": n + 9}[count]
    got = row_move_plain(torch.from_numpy(x), torch.from_numpy(slot), tile, True, cnt)
    want = numpy_row_move(x, slot, tile, True, None if cnt is None else min(int(cnt), n))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        row_move(torch.from_numpy(x), torch.from_numpy(slot), tile, True, cnt).numpy(), want)


@pytest.mark.parametrize("tile", [1, 7, 64, 203])
@pytest.mark.parametrize("w", [1, 3, 5, 36])
def test_row_move_plain_store_matches_numpy(w, tile):
    g = np.random.default_rng(w * 7 + tile)
    n = 203
    x = g.integers(-2**31, 2**31, size=(n, w)).astype(np.int32)
    # a permutation of each tile, with some rows sent outside it
    slot = np.concatenate([g.permutation(min(tile, n - t0)) for t0 in range(0, n, tile)])
    slot = slot.astype(np.int32)
    slot[g.random(n) < 0.2] = tile + 1
    got = row_move_plain(torch.from_numpy(x), torch.from_numpy(slot), tile, False)
    np.testing.assert_array_equal(got.numpy(), numpy_row_move(x, slot, tile, False))


def test_row_move_count_applies_to_the_load_form_only():
    x = torch.zeros((4, 2), dtype=torch.int32)
    slot = torch.zeros(4, dtype=torch.int32)
    for fn in (row_move, row_move_plain):
        with pytest.raises(ValueError, match="load form"):
            fn(x, slot, 4, False, 2)
