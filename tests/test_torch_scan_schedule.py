"""The tile plan of K2 (single-pass segmented scan) and K3 (counted tile
compaction) on the CPU.

``kernels/scan_plan.py`` holds what the wrappers hand to the CUDA kernels:
the tile of ``THREADS`` x ``ITEMS`` rows, the tile count, the scratch
layout and the size refusals.  Here numpy emulations run the kernels'
algorithms tile by tile, at the plan's tile and at small ones:

- K2: in the warp-striped layout (group k of warp w is ``lanes * vec``
  rows, each lane holding ``vec``), each thread scans its rows in
  registers, the warp its lanes with a carry over the groups, and the block
  the warps' totals; every tile publishes its aggregate and then its
  inclusive prefix, and a tile's exclusive prefix comes from a look-back
  over the earlier tiles' status words, a warp's window of 32 at a time,
  that stops at the first inclusive prefix or flagged aggregate (a tile
  whose first row starts a run looks back not at all); reversed scans take
  the tiles from the last and mirror each tile's rows.
- K3: launch 1 counts each tile's kept rows, and its last block turns the
  counts into exclusive offsets and the total, a tile's worth of counts a
  round; launch 2 ranks each tile's rows by warp ballots over the same
  layout and writes the kept and dropped runs to their places, eight words
  a launch, a row-index slot written as ``base + row``.

The emulations are held against the plain versions (``seg_scan_plain``,
``compact_words_plain``) and against the JAX package (``ops/scan.py``'s
``_blocked_scan`` with ``_seg_op``, ``cumsum``; ``ops/movement.compact_words``)
on the same numpy inputs.  Every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.ops import movement as jmove
from database_technology_algorithms_tpu.ops import scan as jscan
from database_technology_algorithms_tpu_torch import batch as tbatch
from database_technology_algorithms_tpu_torch.kernels import scan_plan
from database_technology_algorithms_tpu_torch.kernels.compact import (
    compact_words, compact_words_plain)
from database_technology_algorithms_tpu_torch.kernels.seg_scan import seg_scan, seg_scan_plain

CPU = torch.device("cpu")
MASK = 0xFFFFFFFF
# (warps, groups, lanes, rows a vector): the plan's tile and two small ones,
# so that a few hundred rows span more tiles than a look-back window
GEOMETRIES = {
    "plan": (scan_plan.WARPS, scan_plan.GROUPS, scan_plan.LANES, scan_plan.VEC),
    "16-row": (2, 2, 2, 2),
    "4-row": (2, 1, 2, 1),
}


def tile_of(geometry: str) -> int:
    return int(np.prod(GEOMETRIES[geometry]))


def sizes(geometry: str) -> list[int]:
    t = tile_of(geometry)
    return [0, 1, t - 1, t, t + 1, 3 * t + 5 if geometry == "plan" else 37 * t + 3]


# the sizes also held against the JAX package (each new size compiles there;
# the plain versions equal JAX at every size in tests/test_torch_ops.py)
JAX_SIZES = {1, scan_plan.TILE - 1, scan_plan.TILE + 1, sizes("plan")[-1], sizes("16-row")[-1],
             sizes("4-row")[-1]}


def t32(a) -> torch.Tensor:
    return tbatch.u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


# ---------------------------------------------------------------------------
# K2


def monoid(op: str, signed: bool):
    """(identity, apply) of the value op on u32 bit patterns held in int64."""
    ident = {("add", False): 0, ("add", True): 0, ("min", False): MASK,
             ("min", True): 0x7FFFFFFF, ("max", False): 0, ("max", True): 0x80000000}[op, signed]

    def sval(x):
        return np.where(x >= 1 << 31, x - (1 << 32), x) if signed else x

    def apply(a, b):
        if op == "add":
            return (a + b) & MASK
        pick = np.minimum if op == "min" else np.maximum
        return pick(sval(a), sval(b)) & MASK

    return ident, apply


def combine(apply, a, b):
    """The segmented monoid on (flag, value) pairs (arrays or scalars)."""
    return a[0] | b[0], np.where(b[0], b[1], apply(a[1], b[1]))


def lookback(status, t, ident, apply):
    """Tile t's exclusive prefix from the status words of tiles t-1, t-2,
    ..., WINDOW at a time: the window's words up to its first stop (an
    inclusive prefix, an aggregate with its flag set, or the place before
    tile 0) are combined, earliest first, into what the nearer windows gave.
    Returns (prefix, words read)."""
    acc, used = (False, ident), 0
    for u in range(t - 1, -scan_plan.WINDOW - 1, -scan_plan.WINDOW):
        window, stop = [], False
        for i in range(u, u - scan_plan.WINDOW, -1):
            if i < 0:
                stop = True
                break
            state, f, v = status[i]
            assert state in ("aggregate", "prefix"), f"tile {t} read tile {i} before it published"
            window.append((f, v))
            used += 1
            if state == "prefix" or f:
                stop = True
                break
        pair = (False, ident)
        for p in reversed(window):  # the farthest first
            pair = combine(apply, pair, p)
        acc = combine(apply, pair, acc)
        if stop:
            return acc, used
    raise AssertionError("the look-back ran past tile 0")


def emulate_scan(flags, vals, op, signed, reverse, geometry="plan", schedule="in order"):
    """K2 tile by tile.  `vals` are u32 values (int64) or bools; `flags` a
    bool array or None.  ``schedule="in order"``: each tile publishes its
    inclusive prefix before the next looks back (one word a look-back);
    ``"aggregates first"``: every tile has published only its aggregate when
    the others look back, the longest look-backs.  Returns (out as u32
    int64, words each tile's look-back read, or None where it skipped it)."""
    warps, groups, lanes, vec = GEOMETRIES[geometry]
    tile = tile_of(geometry)
    n = vals.shape[0]
    ntiles = scan_plan.tiles(n, tile)
    ident, apply = monoid(op, signed)
    f_all = np.zeros(n, bool) if flags is None else flags
    v_all = vals.astype(np.int64)
    out = np.zeros(n, np.int64)
    status, blocks, reads = {}, [], []
    for t in range(ntiles):
        rows = scan_plan.tile_rows(t, n, reverse, tile)
        idx = rows.start + np.arange(tile)
        live = idx < n
        f = np.where(live, f_all[np.minimum(idx, n - 1)], False)
        v = np.where(live, v_all[np.minimum(idx, n - 1)], ident)
        if reverse:  # logical position p lies at row tile - 1 - p
            f, v = f[::-1], v[::-1]
        # scan order: warp, group, lane, row
        f, v = f.reshape(warps, groups, lanes, vec), v.reshape(warps, groups, lanes, vec)
        loc, seen = np.zeros(v.shape, np.int64), np.zeros(v.shape, bool)
        excl = np.empty((warps, groups, lanes), object)
        wtot = []
        for w in range(warps):
            carry = (False, ident)
            for k in range(groups):
                # each thread's rows in registers
                agg = (np.zeros(lanes, bool), np.full(lanes, ident, np.int64))
                for i in range(vec):
                    agg = combine(apply, agg, (f[w, k, :, i], v[w, k, :, i]))
                    loc[w, k, :, i], seen[w, k, :, i] = agg[1], agg[0]
                # the warp's exclusive scan of its lanes, after the groups before
                run = carry
                for lane in range(lanes):
                    excl[w, k, lane] = run
                    run = combine(apply, run, (bool(agg[0][lane]), int(agg[1][lane])))
                carry = run
            wtot.append(carry)
        # the warps' exclusive prefixes and the tile's aggregate
        wex, run = [], (False, ident)
        for p in wtot:
            wex.append(run)
            run = combine(apply, run, p)
        status[t] = ("prefix" if t == 0 else "aggregate", bool(run[0]), int(run[1]))
        blocks.append((idx, live, loc, seen, excl, wex, run, bool(f[0, 0, 0, 0])))
        if schedule == "in order":
            reads.append(finish_scan(blocks, t, status, ident, apply, reverse, out))
    if schedule == "aggregates first":  # the last tile looks back first
        reads = [finish_scan(blocks, t, status, ident, apply, reverse, out)
                 for t in reversed(range(ntiles))][::-1]
    return out, reads


def finish_scan(blocks, t, status, ident, apply, reverse, out):
    """Tile t's look-back, its inclusive prefix and its results."""
    idx, live, loc, seen, excl, wex, total, starts = blocks[t]
    prefix, used = (False, ident), None
    if t > 0 and not starts:
        prefix, used = lookback(status, t, ident, apply)
        pf, pv = combine(apply, prefix, total)
        status[t] = ("prefix", bool(pf), int(pv))
    res = loc.copy()
    warps, groups, lanes, _ = loc.shape
    for w in range(warps):
        for k in range(groups):
            for lane in range(lanes):
                before = combine(apply, combine(apply, prefix, wex[w]), excl[w, k, lane])[1]
                res[w, k, lane] = np.where(seen[w, k, lane], loc[w, k, lane],
                                           apply(before, loc[w, k, lane]))
    res = res.reshape(-1)
    if reverse:
        res = res[::-1]
    out[idx[live]] = res[live]
    return used


@functools.lru_cache(maxsize=None)
def jax_scan_fn(op: str, signed: bool, with_flags: bool):
    """The JAX package's K2 function, jitted: _blocked_scan over the
    segmented monoid, or ``cumsum`` for an add without flags."""
    if not with_flags and op == "add":
        return jax.jit(jscan.cumsum)
    dtype = jnp.int32 if signed else jnp.uint32
    ident = {"add": 0, "min": jnp.iinfo(dtype).max, "max": jnp.iinfo(dtype).min}[op]
    inner = {"add": lambda a, b: a + b, "min": jnp.minimum, "max": jnp.maximum}[op]
    return jax.jit(lambda f, v: jscan._blocked_scan(
        jscan._seg_op(inner), (False, jnp.asarray(ident, dtype)), (f, v))[1])


def jax_scan(flags, vals, op, signed, reverse):
    """K2's function in the JAX package on the same inputs; reversed as
    ``flip(scan(flip(f), flip(v)))``."""
    n = vals.shape[0]
    u = vals.astype(np.uint32)
    v = u.view(np.int32) if signed else u
    f = np.zeros(n, bool) if flags is None else flags
    if reverse:
        v, f = v[::-1].copy(), f[::-1].copy()
    fn = jax_scan_fn(op, signed, flags is not None or op != "add")
    out = np.asarray(fn(jnp.asarray(v)) if flags is None and op == "add"
                     else fn(jnp.asarray(f), jnp.asarray(v))).view(np.uint32)
    return out[::-1] if reverse else out


def scan_inputs(g, n: int, case: str, tile: int):
    """u32 values (a fifth >= 2^31) and the run-start flags of one case."""
    vals = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64)
    vals[g.random(n) < 0.2] |= 1 << 31
    rows = np.arange(n)
    flags = {
        "random": g.random(n) < 0.2,
        "tile first row": rows % tile == 0,
        "tile last row": (rows % tile == tile - 1) | (rows == n - 1),
        "no row": np.zeros(n, bool),
        "one run": rows == 0,  # one run across every tile: the longest look-back
        "None": None,
    }[case]
    return flags, vals


SCAN_CASES = ["random", "tile first row", "tile last row", "no row", "one run", "None"]
OPS = [(op, signed) for op in ("add", "min", "max") for signed in (False, True)]


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("geometry,n", [(g, n) for g in GEOMETRIES for n in sizes(g)])
def test_scan_tiles_match_plain_and_jax(geometry, n, case):
    g = np.random.default_rng(n + 7 * SCAN_CASES.index(case))
    flags, vals = scan_inputs(g, n, case, tile_of(geometry))
    tf = None if flags is None else torch.from_numpy(flags)
    for op, signed in OPS:
        for reverse in (False, True):
            got, reads = emulate_scan(flags, vals, op, signed, reverse, geometry)
            want = tbatch.torch_to_u32(seg_scan_plain(tf, t32(vals), op, signed, reverse))
            np.testing.assert_array_equal(got.astype(np.uint32), want)
            if n in JAX_SIZES:
                np.testing.assert_array_equal(want, jax_scan(flags, vals, op, signed, reverse))
            # in order, every look-back reads one word: its predecessor's prefix
            assert all(r in (None, 1) for r in reads)


@pytest.mark.parametrize("geometry", ["16-row", "4-row"])
@pytest.mark.parametrize("case", ["random", "tile first row", "tile last row", "one run"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lookback_stops_at_the_first_flagged_aggregate(geometry, case, reverse):
    """With only aggregates published, tile t reads back to the nearest
    earlier tile whose rows hold a run start, or to tile 0, and no further;
    a tile whose first row starts a run reads nothing."""
    tile = tile_of(geometry)
    n = sizes(geometry)[-1]
    g = np.random.default_rng(11 + len(case))
    flags, vals = scan_inputs(g, n, case, tile)
    if case == "random":
        flags = g.random(n) < 0.5 / tile  # about one run start in two tiles
    ntiles = scan_plan.tiles(n, tile)
    has_start = [bool(flags[scan_plan.tile_rows(t, n, reverse, tile)].any()) for t in range(ntiles)]
    for op, signed in (("add", False), ("min", True), ("max", False)):
        got, reads = emulate_scan(flags, vals, op, signed, reverse, geometry, "aggregates first")
        want = tbatch.torch_to_u32(seg_scan_plain(torch.from_numpy(flags), t32(vals), op, signed,
                                                  reverse))
        np.testing.assert_array_equal(got.astype(np.uint32), want)
        for t in range(1, ntiles):
            first = scan_plan.tile_rows(t, n, reverse, tile)
            if flags[first[-1] if reverse else first[0]]:
                assert reads[t] is None
                continue
            nearest = next((u for u in range(t - 1, -1, -1) if has_start[u]), 0)
            assert reads[t] == t - nearest, (t, reads[t], nearest)
    if case == "one run":  # the look-backs cross several windows of 32
        assert max(r for r in reads if r) > scan_plan.WINDOW


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_scan_bool_values(geometry, op):
    """A bool value column is read as 0/1: the same results as its int32
    copy, in the emulation, the plain version and the wrapper."""
    n = sizes(geometry)[-1]
    g = np.random.default_rng(5)
    bools = g.random(n) < 0.4
    flags = g.random(n) < 0.1
    tf, tb = torch.from_numpy(flags), torch.from_numpy(bools)
    for reverse in (False, True):
        for signed in (False, True):
            got, _ = emulate_scan(flags, bools, op, signed, reverse, geometry)
            want = seg_scan_plain(tf, tb.to(torch.int32), op, signed, reverse)
            np.testing.assert_array_equal(got.astype(np.uint32), tbatch.torch_to_u32(want))
            assert torch.equal(seg_scan(tf, tb, op, signed, reverse), want)
            np.testing.assert_array_equal(
                tbatch.torch_to_u32(want), jax_scan(flags, bools.astype(np.int64), op, signed,
                                                    reverse))


# ---------------------------------------------------------------------------
# K3


def emulate_compact(keep, payload, geometry="plan"):
    """K3 tile by tile: launch 1's counts, its last block's offsets (a
    tile's worth of counts a round) and total; launch 2's ranks from warp
    ballots over the striped layout, the staged runs and the destinations,
    eight words a launch.  A payload slot is a u32 array (int64) or an int
    base for the row index.  Returns (count, words)."""
    warps, groups, lanes, vec = GEOMETRIES[geometry]
    tile = tile_of(geometry)
    n = keep.shape[0]
    ntiles = scan_plan.tiles(n, tile)
    padded = np.zeros(ntiles * tile, bool)
    padded[:n] = keep
    k = padded.reshape(ntiles, warps, groups, lanes, vec)
    # launch 1: the tiles' counts, then the last block's exclusive offsets
    counts = k.sum(axis=(1, 2, 3, 4))
    offs = np.zeros(ntiles, np.int64)
    carry = 0
    for base in range(0, ntiles, tile):
        chunk = counts[base: base + tile]
        offs[base: base + tile] = carry + np.cumsum(chunk) - chunk
        carry += int(chunk.sum())
    total = carry
    # launch 2: ranks in the tile, then each row's destination
    pos = np.arange(tile).reshape(warps, groups, lanes, vec)
    dest = np.empty(n, np.int64)
    for t in range(ntiles):
        kt = k[t].astype(np.int64)
        before = np.zeros((warps, groups, lanes), np.int64)
        wkept = np.zeros(warps, np.int64)
        for w in range(warps):
            kept = 0
            for g in range(groups):
                ballots = kt[w, g].T  # [vec, lanes]: the ballot of each row of the vectors
                below = np.cumsum(ballots.sum(axis=0)) - ballots.sum(axis=0)
                before[w, g] = kept + below
                kept += int(ballots.sum())
            wkept[w] = kept
        wbefore = np.cumsum(wkept) - wkept
        tkept = int(wkept.sum())
        r = wbefore[:, None, None, None] + before[..., None] + np.cumsum(kt, axis=3) - kt
        slot = np.where(kt == 1, r, tkept + pos - r).reshape(-1)
        tile_n = min(tile, n - t * tile)
        staged_dest = np.where(np.arange(tile) < tkept, offs[t] + np.arange(tile),
                               total + t * tile - offs[t] + np.arange(tile) - tkept)
        live = slot[:tile_n]
        assert sorted(live.tolist()) == list(range(tile_n))  # a permutation of the tile
        dest[t * tile + np.arange(tile_n)] = staged_dest[live]
    assert n == 0 or sorted(dest.tolist()) == list(range(n))
    outs = []
    for first in range(0, len(payload), scan_plan.MAX_WORDS):  # one launch 2 each
        for w in payload[first: first + scan_plan.MAX_WORDS]:
            src = (w + np.arange(n)) & MASK if isinstance(w, int) else w
            o = np.zeros(n, np.int64)
            o[dest] = src
            outs.append(o)
    return total, outs


def keep_case(g, n, case):
    return {"random": g.random(n) < 0.4, "all": np.ones(n, bool), "none": np.zeros(n, bool),
            "alternating": np.arange(n) % 2 == 0}[case]


def payload_of(g, n, nwords):
    """`nwords` slots: u32 words, with a row-index slot from 0 and (9 words)
    one from a base of 1000."""
    slots = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64)
             for _ in range(nwords)]
    if nwords > 1:
        slots[1] = 0
    if nwords > 8:
        slots[8] = 1000
    return slots


@pytest.mark.parametrize("nwords", [1, 8, 9])
@pytest.mark.parametrize("case", ["random", "all", "none", "alternating"])
@pytest.mark.parametrize("geometry,n", [(g, n) for g in GEOMETRIES for n in sizes(g)])
def test_compact_tiles_match_plain_and_jax(geometry, n, case, nwords):
    g = np.random.default_rng(3 * n + nwords)
    keep = keep_case(g, n, case)
    slots = payload_of(g, n, nwords)
    count, outs = emulate_compact(keep, slots, geometry)
    tslots = tuple(s if isinstance(s, int) else t32(s) for s in slots)
    pcount, pouts = compact_words_plain(torch.from_numpy(keep), tslots)
    assert count == int(pcount) == int(keep.sum())
    assert pcount.dtype == torch.int32 and pcount.dim() == 0
    for o, p in zip(outs, pouts, strict=True):
        np.testing.assert_array_equal(o.astype(np.uint32), tbatch.torch_to_u32(p))
    if n in JAX_SIZES:
        wcount, wouts = jmove.compact_words(
            jnp.asarray(keep),
            tuple(jnp.asarray(((s + np.arange(n)) if isinstance(s, int) else s).astype(np.uint32))
                  for s in slots))
        assert int(wcount) == count
        for p, w in zip(pouts, wouts, strict=True):
            np.testing.assert_array_equal(tbatch.torch_to_u32(p), np.asarray(w))
    # the wrapper (the plain version on the CPU) takes the same slots
    wcnt, wrapped = compact_words(torch.from_numpy(keep), tslots)
    assert int(wcnt) == count
    for a, b in zip(wrapped, pouts, strict=True):
        assert torch.equal(a, b)


def test_count_offsets_span_rounds():
    """More tiles than one round of launch 1's last block: the offsets carry
    from round to round."""
    tile = tile_of("4-row")
    n = tile * (3 * tile + 1) + 2  # 3 rounds and a bit
    g = np.random.default_rng(9)
    keep = g.random(n) < 0.5
    slots = [g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.int64), 7]
    count, outs = emulate_compact(keep, slots, "4-row")
    pcount, pouts = compact_words_plain(torch.from_numpy(keep), (t32(slots[0]), 7))
    assert count == int(pcount)
    for o, p in zip(outs, pouts, strict=True):
        np.testing.assert_array_equal(o.astype(np.uint32), tbatch.torch_to_u32(p))


# ---------------------------------------------------------------------------
# the plan itself


def test_plan_tiles_and_scratch():
    assert scan_plan.TILE == scan_plan.THREADS * scan_plan.ITEMS == 4096
    for n in (1, 4095, 4096, 4097, 16 * 2**20, 36 * 10**6):
        tiles = scan_plan.tiles(n)
        assert (tiles - 1) * scan_plan.TILE < n <= tiles * scan_plan.TILE
        # the tile counter, a pad to 8 bytes, a 64-bit word a tile
        assert scan_plan.scan_scratch_words(n) == 2 + 2 * tiles
        # the done counter, the count, an offset a tile
        assert scan_plan.compact_scratch_words(n) == 2 + tiles
        for reverse in (False, True):
            covered = [scan_plan.tile_rows(t, n, reverse) for t in range(tiles)]
            assert sum(len(r) for r in covered) == n
            assert covered[-1 if not reverse else 0].stop == n  # the short tile holds the end
            assert all(r.start % scan_plan.TILE == 0 for r in covered)
    assert scan_plan.COUNT_WORD == 1


def test_plan_refusals():
    scan_plan.check_rows("K", scan_plan.MAX_ROWS)
    with pytest.raises(ValueError, match="2\\^31 - 1.*32-bit"):
        scan_plan.check_rows("seg_scan", 2**31)
    scan_plan.check_row_index("K", 0, 2**31)
    scan_plan.check_row_index("K", 2**31 - 5, 5)
    for base, n in ((-1, 4), (2**31 - 4, 5)):
        with pytest.raises(ValueError, match="row-index slot"):
            scan_plan.check_row_index("compact_words", base, n)
    with pytest.raises(ValueError, match="row-index slot"):
        compact_words_plain(torch.ones(3, dtype=torch.bool), (-2,))
