"""The distributed plan's kernels, emulated in numpy as the card runs them,
against their plain torch versions and the JAX package.

- K19 (``csrc/topk_runs.cu``): each position's key, (run count << 32) |
  ~position, its run's end the next start flag of its warp's steps or of a
  later warp of the tile, or nact; the tile's last run looks past the tile
  (32 positions, then a 32-ary search).  Up to 32 picks each warp's list
  in its lanes, keys entering by a ballot and an insert, and the block's
  merge of the warps' lists; past 32 (33 and 1024 here) the block's list
  with its buffer of entrants, sorted whenever it could fill; then the last
  block's pass over every tile's k keys.  At the plan's tile and at small
  tiles that every long run crosses.
- K20 (``csrc/hot_set.cu``): a thread a candidate, the counts of equal
  candidates summed in 32 bits, the first occurrence, the signed threshold;
  under its plan (``dist_plan.hot_plan``) with both sides of the
  skew join in one launch: block mode (one block stages both lists, the
  live entries counted by the block's last barrier) and grid mode (a block
  a chunk of one side, its counts added to a zeroed word), each side's
  threshold max(tot // div, 1) by C's division as the kernel takes it, held
  against the plain version, a group-by reference at the limit a side, JAX's
  ``hot_hash_set`` on both sides, and ``skew_join_local``'s one call a
  device.
- K21 (``csrc/hot_set.cu``) under its plan (``dist_plan.in_set_plan``):
  the vector path's R rows a thread (one load, one R-byte store) with the
  tail's n % R rows taken by the thread past the last whole group, the
  scalar path's R rows a block's width apart, units handed out by a grid
  that may be capped; scan mode's staging of the live entries by warp
  ballots and warp counts, in order, then a compare with each; search
  mode's staging the same way (or of the whole list where the warps'
  counts do not fit beside it), its bitonic network over the next power of
  two with the pairs past the staged entries skipped, then a lower-bound
  search; every row written once.
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

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from database_technology_algorithms_tpu.ops.keys import key_hash as jkey_hash
from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.config import EngineConfig as TConfig
from database_technology_algorithms_tpu_torch.kernels import dist_plan
from database_technology_algorithms_tpu_torch.kernels.hot_set import (
    hot_hashes, hot_hashes_plain, hot_lists, hot_lists_plain, in_hot_set, in_hot_set_plain)
from database_technology_algorithms_tpu_torch.kernels.range_dest import (
    range_dest, range_dest_plain)
from database_technology_algorithms_tpu_torch.kernels.stage_cells import stage_to_cells
from database_technology_algorithms_tpu_torch.kernels.topk_runs import topk_runs, topk_runs_plain
from database_technology_algorithms_tpu_torch.ops.keys import key_hash as tkey_hash
from database_technology_algorithms_tpu_torch.parallel import dist_ops as tdist
from database_technology_algorithms_tpu_torch.parallel import mesh as tmesh
from database_technology_algorithms_tpu_torch.parallel import skew as tskew
from test_torch_cells_schedule import GEOMETRIES, emulate_stage
from test_torch_parallel import meshes, skewed

jpar = importlib.import_module("database_technology_algorithms_tpu.parallel")
jskew = importlib.import_module("database_technology_algorithms_tpu.parallel.skew")
jdist = importlib.import_module("database_technology_algorithms_tpu.parallel.dist_ops")
joverlap = importlib.import_module("database_technology_algorithms_tpu.parallel.overlap")
CPU = torch.device("cpu")
M32 = 0xFFFFFFFF


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


# ---------------------------------------------------------------------------
# K19


# (warps a block, 32-position steps a warp): the plan's tile (4096) and two
# small ones that every long run crosses
K19_GEOMETRIES = {"plan": (dist_plan.TOPK_THREADS // 32, dist_plan.TOPK_WARP_SPAN // 32),
                  "2x2": (2, 2), "1x1": (1, 1)}
LANE = np.arange(32)


def k19_run_end(hs: np.ndarray, lo: int, nact: int, h: int, probes: list) -> int:
    """csrc/topk_runs.cu run_end: the first q in [lo, nact] with q == nact or
    hs[q] != h; the next 32 positions, then a 32-ary search.  Appends each
    step's probes."""
    n = len(hs)
    a, b = lo, nact
    q = a + LANE
    past = (q >= b) | (hs[np.minimum(q, n - 1)] != h)
    probes.append(q[q < b])
    if past.any():
        return int(q[np.argmax(past)])
    a += 32
    while a < b:
        w = -(-(b - a) // 32)
        q = a + (LANE + 1) * w - 1
        past = (q >= b) | (hs[np.minimum(q, n - 1)] != h)
        probes.append(q[q < b])
        if not past.any():
            return b
        f = int(np.argmax(past))
        if f > 0:
            a = a + f * w
        b = min(int(q[f]), b)
    return a


def k19_tile_keys(hs: np.ndarray, n: int, nact: int, t0: int, warps: int, chunks: int,
                  stats: dict) -> np.ndarray:
    """The keys of one tile, [warp, step, lane], by the kernel's rule: a
    ballot of start flags a step; a run ends at the next start in its step,
    a later step, a later warp's first start, or nact; only the warp that
    holds the tile's last start looks past the tile."""
    span = 32 * chunks
    p = t0 + np.arange(warps * span).reshape(warps, chunks, 32)
    h = np.where(p < n, hs[np.minimum(p, n - 1)], M32)
    prev = np.where(p > 0, hs[np.clip(p - 1, 0, n - 1)], 0)
    start = (p < nact) & ((p == 0) | (h != prev))
    first = [int(p[w][start[w]].min()) if start[w].any() else None for w in range(warps)]
    keys = np.zeros(p.shape, np.uint64)
    te = min(t0 + warps * span, n)
    for w in range(warps):
        if first[w] is None:
            keys[w] = np.where(p[w] < n, ~p[w] & M32, 0)
            continue
        later = [f for f in first[w + 1:] if f is not None]
        if later:
            after = later[0]
        elif te >= nact:
            after = nact
        else:
            stats["lookaheads"] += 1
            after = k19_run_end(hs, te, nact, int(hs[te - 1]), stats["probes"])
        nxt = after
        for c in reversed(range(chunks)):
            starts = p[w, c][start[w, c]]
            for lane in range(32):
                pos = int(p[w, c, lane])
                cnt = 0
                if start[w, c, lane]:
                    nexts = starts[starts > pos]
                    cnt = min(int(nexts[0]) if len(nexts) else nxt, nact) - pos
                keys[w, c, lane] = (cnt << 32) | (~pos & M32) if pos < n else 0
            if len(starts):
                nxt = int(starts[0])
    return keys


def k19_warp_sort(x: np.ndarray) -> np.ndarray:
    """warp_sort_desc: the bitonic network across 32 lanes by xor shuffles."""
    x = x.copy()
    lane = LANE
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            y = x[lane ^ stride]
            keep_max = ((lane & stride) == 0) == ((lane & size) == 0)
            x = np.where(keep_max, np.maximum(x, y), np.minimum(x, y))
            stride //= 2
        size *= 2
    return x


def k19_warp_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The 32 largest of two lists sorted descending: the larger of a[j] and
    b[31 - j] (bitonic), sorted by warp_merge_desc's five xor stages."""
    x = np.maximum(a, b[::-1])
    stride = 16
    while stride:
        y = x[LANE ^ stride]
        x = np.where((LANE & stride) == 0, np.maximum(x, y), np.minimum(x, y))
        stride //= 2
    assert (np.diff(x.astype(np.float64)) <= 0).all()
    return x


def k19_merge_warps(lists: np.ndarray) -> np.ndarray:
    """merge_warps: levels of pairs, warp w taking warp w + level's list."""
    lists = lists.copy()
    level = 1
    while level < len(lists):
        for w in range(0, len(lists), 2 * level):
            if w + level < len(lists):
                lists[w] = k19_warp_merge(lists[w], lists[w + level])
        level *= 2
    return lists[0]


def k19_warp_offer(v: np.ndarray, x: np.ndarray, k: int, stats: dict, floor: int = 0) -> None:
    """warp_offer: lane j of `v` holds the warp's j-th largest key (0 past
    k); the step's keys `x` that beat the k-th and the floor enter, lowest
    lane first, by a shuffle insert."""
    thr = max(floor, int(v[k - 1]))
    cand = [c for c in range(32) if x[c] > thr]
    while cand:
        c = cand.pop(0)
        y = x[c]
        at = int((v > y).sum())
        assert at < k
        v[at + 1: k] = v[at: k - 1].copy()
        v[at] = y
        stats["inserts"] += 1
        thr = max(floor, int(v[k - 1]))
        cand = [d for d in cand if x[d] > thr]


def k19_block_list(rounds, k: int, threads: int, stats: dict, floor: int = 0,
                   early: bool = False) -> np.ndarray:
    """The k > 32 form: a list of k keys and a buffer of entrants in
    TOPK_BIG_SORT keys; each round TOPK_BIG_ROUND keys a thread enter where
    they beat the list's k-th and the floor, the buffer sorted into the list
    (the least power of 2, at least 64, that holds them) whenever the round
    could overfill it, after the first round where `early`, and once at the
    end."""
    s = np.zeros(dist_plan.TOPK_BIG_SORT, np.uint64)
    cnt, thr = 0, floor

    def flush():
        nonlocal cnt, thr
        used = k + cnt
        size = 64
        while size < used:
            size *= 2
        assert size <= dist_plan.TOPK_BIG_SORT
        s[used: size] = 0
        s[:size] = np.sort(s[:size])[::-1]
        cnt, thr = 0, max(thr, int(s[k - 1]))
        stats["sorts"] += 1
        stats["sorted_keys"] += size

    for i, x in enumerate(rounds):
        assert len(x) == threads * dist_plan.TOPK_BIG_ROUND
        if cnt + len(x) > dist_plan.TOPK_BIG_SORT - k:
            flush()
        entrants = x[x > thr]
        s[k + cnt: k + cnt + len(entrants)] = entrants
        cnt += len(entrants)
        if early and i == 0:
            flush()
    flush()
    return s[:k]


def k19_emulate(hs: np.ndarray, nact: int, k: int, geometry: str) -> tuple[np.ndarray, np.ndarray,
                                                                           dict]:
    """csrc/topk_runs.cu at `geometry`: each tile's keys, its k largest (per
    warp and then the block's bitonic merge up to TOPK_WARP_K, the block's
    list past it), then the last block's pass over every tile's k keys."""
    warps, chunks = K19_GEOMETRIES[geometry]
    threads, tile = 32 * warps, warps * 32 * chunks
    hs = np.asarray(hs, np.uint64)
    n = len(hs)
    nact = min(max(nact, 0), n)
    small = k <= dist_plan.TOPK_WARP_K
    stats = {"lookaheads": 0, "probes": [], "inserts": 0, "sorts": 0, "sorted_keys": 0}
    winners = []
    for t0 in range(0, n, tile):
        keys = k19_tile_keys(hs, n, nact, t0, warps, chunks, stats)
        if small:  # the first step sorted, then inserts, then the pairwise merge
            lists = np.zeros((warps, 32), np.uint64)
            for w in range(warps):
                lists[w] = np.where(LANE < k, k19_warp_sort(keys[w, 0]), 0)
                for c in range(1, chunks):
                    k19_warp_offer(lists[w], keys[w, c], k, stats)
            winners.append(k19_merge_warps(lists)[:k])
        else:  # a round: every thread's keys of TOPK_BIG_ROUND steps
            rnd = dist_plan.TOPK_BIG_ROUND
            steps = np.concatenate([keys, np.zeros((warps, -chunks % rnd, 32), np.uint64)], 1)
            winners.append(k19_block_list(
                [steps[:, c: c + rnd].reshape(-1) for c in range(0, steps.shape[1], rnd)], k,
                threads, stats, early=True))
    cand = np.concatenate(winners)
    m = len(cand)
    # merge_floor: no key at or under the largest tile's k-th key less one wins
    floor = max(int(max(w[k - 1] for w in winners)) - 1, 0)
    stats["floor"] = floor
    if small:  # the last block's warps stream over the keys, 4 steps at a time
        lists = np.zeros((warps, 32), np.uint64)
        for base in range(0, m, 4 * threads):
            for w in range(warps):
                for r in range(4):
                    j = base + r * threads + 32 * w + LANE
                    k19_warp_offer(lists[w], np.where(j < m, cand[np.minimum(j, m - 1)], 0),
                                   k, stats, floor)
        best = k19_merge_warps(lists)[:k]
    else:
        per = threads * dist_plan.TOPK_BIG_ROUND
        best = k19_block_list([np.where(j < m, cand[np.minimum(j, m - 1)], 0).astype(np.uint64)
                               for j in (b + np.arange(per) for b in range(0, m, per))],
                              k, threads, stats, floor=floor)
    assert (best > 0).all()  # k <= n real keys
    stats["best"] = best
    pos = (~best) & M32
    return hs[pos].astype(np.uint32), (best >> np.uint64(32)).astype(np.int32), stats


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


@pytest.mark.parametrize("k", ["the case's", 33, 1024])
@pytest.mark.parametrize("geometry", list(K19_GEOMETRIES))
@pytest.mark.parametrize("case", TOPK_CASES)
def test_k19_emulation_matches_plain_and_jax(case, geometry, k):
    g = np.random.default_rng(len(case))
    hs, nact, k0 = topk_input(case, g)
    n = len(hs)
    k = k0 if k == "the case's" else min(k, n)  # local_topk_hashes clamps k to n
    emu_h, emu_c, stats = k19_emulate(hs, nact, k, geometry)
    got = topk_runs_plain(t32(hs), nact, k)
    np.testing.assert_array_equal(torch_to_u32(got[0]), emu_h)
    np.testing.assert_array_equal(got[1].numpy(), emu_c)
    # the JAX package sorts the masked hashes itself: any order of the live
    # rows with the dead ones anywhere gives the same arrays
    perm = g.permutation(n)
    active = np.arange(n)[perm] < nact
    wh, wc = jskew.local_topk_hashes(jnp.asarray(hs[perm]), jnp.asarray(active), k)
    np.testing.assert_array_equal(np.asarray(wh), emu_h)
    np.testing.assert_array_equal(np.asarray(wc), emu_c)
    # at most one look-ahead a tile, and a look-ahead reads only live rows
    tile = 32 * int(np.prod(K19_GEOMETRIES[geometry]))
    assert stats["lookaheads"] <= -(-n // tile)
    assert all((q < max(nact, 0)).all() for q in stats["probes"])
    if case == "run crossing every tile" and geometry != "plan":
        # the long run's start looks ahead once; the tiles inside it have no
        # start and look ahead not at all
        inside = 2500 // tile - 1
        assert stats["lookaheads"] <= -(-n // tile) - inside
        assert len(stats["probes"]) <= 1 + 3 * stats["lookaheads"]
    if k <= dist_plan.TOPK_WARP_K:
        assert stats["sorts"] == 0
    else:
        assert stats["inserts"] == 0 and stats["sorts"] >= 1
    # the merge's floor lies below the k-th key of all
    assert stats["floor"] < int(stats["best"][-1])


def test_k19_count_on_the_device_and_refusals():
    hs, nact, k = topk_input("zipf", np.random.default_rng(2))
    a = topk_runs(t32(hs), torch.tensor(nact, dtype=torch.int32), k)
    b = topk_runs(t32(hs), nact, k)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert dist_plan.topk_scratch_words(len(hs), k) == 2 + 2 * k * dist_plan.topk_tiles(len(hs))
    assert dist_plan.TOPK_TILE == 4096 and dist_plan.TOPK_MAX_K + (
        dist_plan.TOPK_BIG_ROUND * dist_plan.TOPK_THREADS) <= dist_plan.TOPK_BIG_SORT
    for bad in (0, len(hs) + 1):
        with pytest.raises(ValueError, match="K19"):
            topk_runs(t32(hs), nact, bad)
    # past K19's shared memory the runs are sorted instead (no refusal)
    big = dist_plan.TOPK_MAX_K + 1
    assert all(torch.equal(x, y) for x, y in zip(topk_runs(t32(hs), nact, big),
                                                 topk_runs_plain(t32(hs), nact, big)))


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
    """K20's plan refuses past its shared memory; the wrapper sorts the
    candidates there instead (the plain version's [m, m] matrix would take
    gigabytes, so the group-by reference holds it)."""
    n = dist_plan.HOT_MAX_CANDIDATES + 1
    with pytest.raises(ValueError, match="K20"):
        dist_plan.hot_plan(n, 0, "hot_hashes")
    g = np.random.default_rng(20)
    gh = g.integers(0, 500, n).astype(np.uint32) * np.uint32(2654435761)
    gh[::11] = M32
    gc = g.integers(0, 50, n).astype(np.int32)
    np.testing.assert_array_equal(
        torch_to_u32(hot_hashes(t32(gh), torch.from_numpy(gc), 100)), k20_reference(gh, gc, 100))
    assert hot_hashes_plain(torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.int32), 1).numel() == 0


def k20_threshold(tot: int, div: int) -> int:
    """csrc/hot_set.cu side_threshold: C's truncating quotient, one less where
    it truncated a negative one (a floor), at least 1; at div 0, tot."""
    if div == 0:
        return tot
    q = abs(tot) // div * (1 if tot >= 0 else -1)
    q -= tot - q * div != 0 and tot < 0
    return max(q, 1)


def k20_lists_emulate(sides, div: int, plan) -> tuple[np.ndarray, int, dict]:
    """hot_lists_kernel under `plan` over one or two sides, each (gh u32,
    gc int32, tot): (hot u32[m], n_hot, stats)."""
    gh = np.concatenate([np.asarray(s[0], np.uint32) for s in sides] + [np.zeros(0, np.uint32)])
    gc = np.concatenate([np.asarray(s[1], np.int64) for s in sides] + [np.zeros(0, np.int64)])
    m_p, m = len(sides[0][0]), len(gh)
    tots = [int(s[2]) for s in sides]
    hot = np.zeros(m, np.uint32)
    written = np.zeros(m, np.int64)
    t = plan.threads
    blocks0 = -(-m_p // t)
    n_hot, stats = 0, {"staged": 0}  # grid mode's word is zeroed by a memset first
    assert plan.blocks == (1 if plan.block else blocks0 + -(-(m - m_p) // t))
    for blk in range(plan.blocks):
        if plan.block:
            lo, hi, g = 0, m, np.arange(t)
        else:
            second = blk >= blocks0
            lo, hi = (m_p, m) if second else (0, m_p)
            g = lo + (blk - (blocks0 if second else 0)) * t + np.arange(t)
        assert 8 * (hi - lo) <= plan.shared_bytes
        stats["staged"] = max(stats["staged"], hi - lo)
        sh, sc = gh[lo:hi], gc[lo:hi]
        v = np.full(t, M32, np.uint32)
        for k in np.flatnonzero(g < hi):
            side = int(g[k] >= m_p)
            i = g[k] - lo
            frm, to = (m_p if side else 0) - lo, (m if side else m_p) - lo
            eq = sh[frm:to] == sh[i]
            tot = int(sc[frm:to][eq].sum()) & M32
            tot = tot - (1 << 32) if tot >= 1 << 31 else tot
            first = not eq[:i - frm].any()
            if first and tot > k20_threshold(tots[side], div) and sh[i] != M32:
                v[k] = sh[i]
            hot[g[k]] = v[k]
            written[g[k]] += 1
        live = int((v != M32).sum())  # __syncthreads_count over the block's threads
        n_hot = live if plan.block else n_hot + live
    assert (written == 1).all()
    return hot, n_hot, stats


def k20_reference(gh: np.ndarray, gc: np.ndarray, thr: int) -> np.ndarray:
    """The hot list by a group-by (no [m, m] matrix): each hash's counts
    summed mod 2^32 and compared signed, kept at its first occurrence."""
    gh = np.asarray(gh, np.uint32)
    u, first, inv = np.unique(gh, return_index=True, return_inverse=True)
    tot = np.zeros(len(u), np.int64)
    np.add.at(tot, inv, np.asarray(gc, np.int64))
    tot = (tot & M32).astype(np.uint32).view(np.int32).astype(np.int64)
    keep = np.zeros(len(gh), bool)
    keep[first] = True
    return np.where(keep & (tot[inv] > thr) & (gh != M32), gh, np.uint32(M32)).astype(np.uint32)


DIV = 16  # ndev * hh_factor of a 4-shard mesh


def k20_side(case: str, g, m: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(gh, gc, tot) of one side: m gathered candidates, 4 shards' top lists."""
    if case == "all sentinels":
        return np.full(m, M32, np.uint32), g.integers(0, 40, m).astype(np.int32), 800
    shard = max(m // 4, 1)
    pool = g.choice(np.array([5, 2**31 + 1, 9, 12, 2**32 - 2, 77], np.uint64), shard)
    gh = np.resize(pool, m).astype(np.uint32)  # duplicates across the shards' lists
    gh[g.random(m) < 0.2] = M32
    gc = g.integers(0, 40, m).astype(np.int32)
    tot = int(g.integers(0, 2000))
    if case == "wrapping sums":
        gc[:] = 2**30
    elif case == "threshold equal to a sum":
        h = gh[gh != M32][:1]
        if len(h):
            tot = DIV * int(gc[gh == h[0]].astype(np.int64).sum())
    elif case == "tot // div = 0":
        tot, gc[:] = DIV - 1, 1
        gc[:m // 2] = 2
    elif case == "negative tot":  # a psum that wrapped: the floor, then the clamp
        tot = -37
    return gh, gc, tot


K20_SIZES = [(0, 0), (1, 1), (64, 64), (64, 0), (0, 64), (1, 64)]
K20_CASES = ["mixed", "all sentinels", "wrapping sums", "threshold equal to a sum",
             "tot // div = 0", "negative tot"]


def check_k20_lists(sides, plan, want_block: bool):
    """The two-sided emulation against the plain version (each side's list,
    the cat, the count) and the wrapper's CPU route."""
    assert plan.block == want_block
    (ghp, gcp, tp), (ghb, gcb, tb) = sides
    args = (t32(ghp), torch.from_numpy(gcp), torch.tensor(tp, dtype=torch.int32),
            t32(ghb), torch.from_numpy(gcb), torch.tensor(tb, dtype=torch.int32), DIV)
    want, want_n = hot_lists_plain(*args)
    got, got_n = hot_lists(*args)
    np.testing.assert_array_equal(torch_to_u32(got), torch_to_u32(want))
    assert int(got_n) == int(want_n) and got_n.dtype == torch.int32
    emu, n_hot, _ = k20_lists_emulate(sides, DIV, plan)
    np.testing.assert_array_equal(emu, torch_to_u32(want))
    assert n_hot == int(want_n) == int((emu != M32).sum())
    cat = np.concatenate([k20_reference(ghp, gcp, max(tp // DIV, 1)),
                          k20_reference(ghb, gcb, max(tb // DIV, 1))])
    np.testing.assert_array_equal(emu, cat)


@pytest.mark.parametrize("mode", ["block", "grid"])
@pytest.mark.parametrize("case", K20_CASES)
@pytest.mark.parametrize("m_p,m_b", K20_SIZES)
def test_k20_two_sided_emulation_matches_plain(m_p, m_b, case, mode, monkeypatch):
    g = np.random.default_rng(m_p * 7 + m_b + len(case))
    sides = [k20_side(case if side == "p" or case != "all sentinels" else "mixed", g, m)
             for side, m in (("p", m_p), ("b", m_b))]
    if mode == "grid":  # blocks of 32: grid mode from 33 candidates
        monkeypatch.setattr(dist_plan, "HOT_THREADS", 32)
    plan = dist_plan.hot_plan(m_p, m_b)
    check_k20_lists(sides, plan, mode == "block" or m_p + m_b <= 32)


def test_k20_two_sided_at_the_limit_a_side():
    """HOT_MAX_CANDIDATES on the probe side and 64 on the build side: grid
    mode, each block staging its side whole (the plain version's [m, m]
    matrix would take gigabytes here, so the group-by reference holds it)."""
    g = np.random.default_rng(29)
    m = dist_plan.HOT_MAX_CANDIDATES
    ghp = g.integers(0, 3000, m).astype(np.uint32) * np.uint32(2654435761)
    ghp[::97] = M32
    gcp = g.integers(0, 400, m).astype(np.int32)
    ghb, gcb, tb = k20_side("mixed", g, 64)
    plan = dist_plan.hot_plan(m, 64)
    assert not plan.block and plan.shared_bytes == 8 * m <= dist_plan.SHARED_BYTES
    tp = 40_000
    emu, n_hot, stats = k20_lists_emulate([(ghp, gcp, tp), (ghb, gcb, tb)], DIV, plan)
    assert stats["staged"] == m
    want = np.concatenate([k20_reference(ghp, gcp, tp // DIV), k20_reference(ghb, gcb, tb // DIV)])
    np.testing.assert_array_equal(emu, want)
    assert n_hot == int((want != M32).sum()) > 0
    with pytest.raises(ValueError, match="K20"):
        dist_plan.hot_plan(m + 1, 0)
    with pytest.raises(ValueError, match="K20"):
        dist_plan.hot_plan(0, m + 1)


@pytest.mark.parametrize("tot", [-2**31, -33, -32, -1, 0, 1, 15, 16, 17, 2**31 - 1])
def test_k20_threshold_is_torch_floor_division(tot):
    want = int((torch.tensor(tot, dtype=torch.int32) // DIV).clamp(min=1))
    assert k20_threshold(tot, DIV) == want
    assert k20_threshold(tot, 0) == tot


def test_k20_one_sided_launch_is_the_same_kernel():
    """hot_hashes is the one-sided case: div 0 (the threshold itself), no
    count; its plan is the two-sided plan with no build side."""
    g = np.random.default_rng(20)
    gh, gc = candidates("mixed", g, 64)
    plan = dist_plan.hot_plan(64, 0, "hot_hashes")
    emu, _, _ = k20_lists_emulate([(gh, gc, 30)], 0, plan)
    np.testing.assert_array_equal(emu, k20_emulate(gh, gc, 30))
    with pytest.raises(ValueError, match="div"):
        hot_lists(t32(gh), torch.from_numpy(gc), torch.tensor(1), t32(gh), torch.from_numpy(gc),
                  torch.tensor(1), 0)


@functools.lru_cache(maxsize=None)
def jax_hot_lists(kind, seed: int):
    """Both sides' hot lists in JAX's skew join order (probe, then build), and
    n_hot, inside shard_map: a copy a shard."""
    jm, _ = meshes(kind)
    ndev = jpar.mesh_size(jm)
    probe = skewed(300 * ndev, seed, 7, 0.4, key_range=200)
    build = skewed(200 * ndev - 11, seed + 1, 9, 0.3, key_range=200)
    jp, jb = jdist.distribute(jm, probe), jdist.distribute(jm, build)
    ax = jm.axis_names if len(jm.axis_names) > 1 else jm.axis_names[0]
    row = P(jm.axis_names)

    @functools.partial(shard_map, mesh=jm, in_specs=(row,) * 4, out_specs=(row, row),
                       check_vma=False)
    def body(pb, pc, bb, bc):
        def side(batch, count):
            active = jnp.arange(batch.nrows) < count[0]
            thr = jnp.maximum(jax.lax.psum(count[0], ax) // (ndev * 4), 1).astype(jnp.int32)
            return jskew.hot_hash_set(jkey_hash(batch, 1), active, ax, 16, thr)

        hot = jnp.concatenate([side(pb, pc), side(bb, bc)])
        return hot, jnp.sum(hot != jnp.uint32(M32)).astype(jnp.int32).reshape(1)

    hot, n_hot = jax.jit(body)(jp.batch, jp.count, jb.batch, jb.count)
    return probe, build, np.asarray(hot).reshape(ndev, -1), np.asarray(n_hot)


@pytest.mark.parametrize("kind", [8, 4, 3])
def test_k20_two_sided_matches_jax_hot_hash_set(kind, monkeypatch):
    """The port's gathered candidates of both sides through hot_lists (once a
    device: the shards of the CPU mesh share it) and through the emulation in
    both modes, against JAX's two hot_hash_set calls, the cat and the count."""
    probe, build, want, want_n = jax_hot_lists(kind, 5)
    _, tm = meshes(kind)
    ndev = tmesh.mesh_size(tm)
    tp, tb = tdist.distribute(tm, probe), tdist.distribute(tm, build)

    def side(t):
        hashes = [tkey_hash(b, 1) for b in t.batches]
        active = [torch.arange(b.nrows) < c for b, c in zip(t.batches, t.counts)]
        return tskew.gathered_candidates(tm, hashes, active, 16)

    (ghp, gcp), (ghb, gcb) = side(tp), side(tb)
    totp, totb = tm.psum(tp.counts), tm.psum(tb.counts)
    got = tm.per_device(lambda *a: hot_lists(*a, ndev * 4), ghp, gcp, totp, ghb, gcb, totb)
    assert len({id(x) for x in got}) == 1  # one CPU device: one list, shared
    for d in range(ndev):
        np.testing.assert_array_equal(torch_to_u32(got[d][0]), want[d])
        assert int(got[d][1]) == int(want_n[d])
    assert (want[0] != M32).any()
    sides = [(torch_to_u32(ghp[0]), gcp[0].numpy(), int(totp[0])),
             (torch_to_u32(ghb[0]), gcb[0].numpy(), int(totb[0]))]
    for threads in (dist_plan.HOT_THREADS, 32):
        monkeypatch.setattr(dist_plan, "HOT_THREADS", threads)
        plan = dist_plan.hot_plan(len(sides[0][0]), len(sides[1][0]))
        emu, n_hot, _ = k20_lists_emulate(sides, ndev * 4, plan)
        np.testing.assert_array_equal(emu, want[0])
        assert n_hot == int(want_n[0])


def test_skew_join_local_calls_hot_lists_once_a_device(monkeypatch):
    """On a 4-shard mesh of one device the skew join reduces both sides'
    candidates in one hot_lists call, and hot_hash_set one hot_hashes call;
    the wrappers are spied on, nothing is counted by kernel."""
    mesh = tmesh.make_mesh(4, devices="cpu")
    calls = {"hot_lists": 0, "hot_hashes": 0}
    for name in calls:
        real = getattr(tskew, name)

        def spy(*a, real=real, name=name):
            calls[name] += 1
            return real(*a)

        monkeypatch.setattr(tskew, name, spy)
    build, probe = skewed(400, 1, 7, 0.0), skewed(1200, 2, 7, 0.5)
    cfg = TConfig(hh_factor=4, hh_topk=8)
    _, _, _, n_hot = tskew.dist_hash_join_skew(mesh, tdist.distribute(mesh, build),
                                               tdist.distribute(mesh, probe), 1, cfg)
    assert calls == {"hot_lists": 1, "hot_hashes": 0} and int(n_hot) >= 1
    t = tdist.distribute(mesh, probe)
    hashes = [tkey_hash(b, 1) for b in t.batches]
    active = [torch.arange(b.nrows) < c for b, c in zip(t.batches, t.counts)]
    lists = tskew.hot_hash_set(mesh, hashes, active, 8, mesh.psum(t.counts))
    assert calls["hot_hashes"] == 1 and len({id(x) for x in lists}) == 1


def test_hot_hash_set_keeps_each_shards_own_threshold():
    """Shards of one device that pass different thresholds each get the list
    for their own threshold (one hot_hashes call a shard); shards that pass
    the one threshold tensor share one list."""
    mesh = tmesh.make_mesh(4, devices="cpu")
    t = tdist.distribute(mesh, skewed(1200, 2, 7, 0.5))
    hashes = [tkey_hash(b, 1) for b in t.batches]
    active = [torch.arange(b.nrows) < c for b, c in zip(t.batches, t.counts)]
    gh, gc = tskew.gathered_candidates(mesh, hashes, active, 8)
    thr = [torch.tensor(v, dtype=torch.int32) for v in (1, 2, 40, 10**6)]
    lists = tskew.hot_hash_set(mesh, hashes, active, 8, thr)
    for got, tv in zip(lists, thr):
        np.testing.assert_array_equal(got.numpy(), hot_hashes_plain(gh[0], gc[0], tv).numpy())
    assert len({torch_to_u32(x).tobytes() for x in lists}) > 1
    shared = tskew.hot_hash_set(mesh, hashes, active, 8, [thr[1]] * 4)
    assert len({id(x) for x in shared}) == 1
    np.testing.assert_array_equal(shared[0].numpy(), lists[1].numpy())


def k21_stage_live(hot: np.ndarray, threads: int) -> np.ndarray:
    """Scan mode's staging: rounds of `threads` entries, each warp's live
    entries ranked by its ballot and placed after the earlier warps' counts
    and the earlier rounds' entries."""
    staged = np.full(len(hot), M32, np.uint64)
    live = 0
    for c in range(0, len(hot), threads):
        v = np.full(threads, M32, np.uint64)
        v[: len(hot[c:c + threads])] = hot[c:c + threads]
        flags = (v != M32).reshape(-1, 32)
        counts = flags.sum(1)
        for t in np.flatnonzero(v != M32):
            w, lane = divmod(int(t), 32)
            staged[live + counts[:w].sum() + flags[w, :lane].sum()] = v[t]
        live += int(counts.sum())
    return staged[:live]


def k21_sort(hot: np.ndarray) -> np.ndarray:
    """Search mode's bitonic network: over p = the next power of two >= mh,
    every comparator puts the smaller value at the lower index; a stage k
    pairs each lower-half index with its mirror i ^ (k - 1), then with
    i + j; a pair whose upper index is past mh is skipped."""
    a = np.asarray(hot, np.uint64).copy()
    mh = len(a)
    p = 1
    while p < mh:
        p *= 2
    k = 2
    while k <= p:
        j = k // 2
        while j:
            i = np.arange(p // 2)
            lo = ((i & ~(j - 1)) << 1) | (i & (j - 1))
            hi = lo ^ (k - 1) if j == k // 2 else lo + j
            lo, hi = lo[hi < mh], hi[hi < mh]
            assert len(np.unique(np.concatenate([lo, hi]))) == 2 * len(lo)  # disjoint pairs
            x, y = a[lo].copy(), a[hi].copy()
            swap = y < x
            a[lo[swap]], a[hi[swap]] = y[swap], x[swap]
            j //= 2
        k *= 2
    return a


def k21_search(sorted_hot: np.ndarray, h: np.ndarray) -> np.ndarray:
    """The lower-bound search of each row in the sorted list: steps of the
    largest power of two <= mh down to 1; found where the row is no sentinel
    and the entry at its bound equals it."""
    mh = len(sorted_hot)
    if mh == 0:
        return np.zeros(len(h), bool)
    top = 1
    while top * 2 <= mh:
        top *= 2
    pos, s = np.zeros(len(h), np.int64), top
    while s:
        cand = pos + s
        adv = (cand <= mh) & (sorted_hot[np.minimum(cand, mh) - 1] < h)
        pos = np.where(adv, cand, pos)
        s //= 2
    return (h != M32) & (pos < mh) & (sorted_hot[np.minimum(pos, mh - 1)] == h)


def k21_emulate(hashes, hot, plan=None) -> np.ndarray:
    """csrc/hot_set.cu's K21 under `plan` (``dist_plan.in_set_plan``; by
    default the one the wrapper makes for a contiguous, aligned column),
    thread by thread: units u, u + blocks * threads, ... of each thread;
    every row written once."""
    h, hot = np.asarray(hashes, np.uint64), np.asarray(hot, np.uint64)
    n, mh = len(h), len(hot)
    if plan is None:
        plan = dist_plan.in_set_plan(n, mh, 0, 0)
    r, t = plan.rows, plan.threads
    if plan.search:  # the live entries, or all where the warps' counts do not fit beside them
        compact = 4 * max(mh, 1) + t // 8 <= dist_plan.SHARED_BYTES
        staged = k21_stage_live(hot, t) if compact else hot
        s_hot = k21_sort(staged)
        np.testing.assert_array_equal(s_hot, np.sort(staged))
        member = lambda x: k21_search(s_hot, x)  # noqa: E731
    else:
        s_hot = k21_stage_live(hot, t)
        np.testing.assert_array_equal(s_hot, hot[hot != M32])
        member = lambda x: (x[:, None] == s_hot[None, :]).any(1)  # noqa: E731
    units = -(-n // r) if plan.vec else -(-n // (t * r)) * t
    out, written = np.zeros(n, bool), np.zeros(n, np.int64)
    stores = 0
    for first in range(plan.blocks * t):
        for u in range(first, units, plan.blocks * t):
            if plan.vec:
                full = n // r
                rows = np.arange(r * u, r * u + r) if u < full else np.arange(
                    r * full, n if u == full else r * full)
                stores += u < full  # one R-byte store
            else:
                c, lane = divmod(u, t)
                rows = c * t * r + lane + t * np.arange(r)
                rows = rows[rows < n]
            out[rows] = member(h[rows])
            written[rows] += 1
    assert (written == 1).all(), "a row written twice or never"
    assert stores == (n // r if plan.vec else 0)
    return out


def k21_list(case: str, g, h: np.ndarray, mh: int) -> np.ndarray:
    hot = np.full(mh, M32, np.uint64)
    if case == "mixed":
        hot[g.choice(mh, min(9, mh), replace=False)] = g.choice(h, min(9, mh))
    elif case == "duplicates":
        hot[:] = np.repeat(g.choice(h, -(-mh // 8)), 8)[:mh]
        hot[::5] = M32
    elif case == "all live":
        hot[:] = g.choice(h, mh)
    return hot.astype(np.uint32)


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


def k21_plan_of(h_t: torch.Tensor, mh: int):
    """K21's plan for this column, as the wrapper makes it (the output a
    fresh, aligned allocation)."""
    n = h_t.shape[0]
    return dist_plan.in_set_plan(n, mh, h_t.data_ptr(),
                                 torch.empty(max(n, 1), dtype=torch.bool).data_ptr())


def check_k21(h: np.ndarray, hot: np.ndarray, offset: int, want_vec=None, want_search=None):
    """K21's emulation under the wrapper's plan for `h` placed `offset`
    words into its buffer, against the wrapper (the plain version here),
    the plain version and the JAX package."""
    buf = t32(np.concatenate([np.zeros(offset, np.uint32), h]))
    h_t = buf[offset:]
    plan = k21_plan_of(h_t, len(hot))
    if want_vec is not None:
        assert plan.vec == want_vec
    if want_search is not None:
        assert plan.search == want_search
    emu = k21_emulate(h, hot, plan)
    np.testing.assert_array_equal(in_hot_set(h_t, t32(hot)).numpy(), emu)
    np.testing.assert_array_equal(in_hot_set_plain(h_t, t32(hot)).numpy(), emu)
    if len(hot):
        np.testing.assert_array_equal(
            np.asarray(jskew.in_hash_set(jnp.asarray(h), jnp.asarray(hot))), emu)
    want = np.isin(h, hot[hot != M32])
    np.testing.assert_array_equal(emu, want)
    return plan


@pytest.mark.parametrize("tail", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case,mh", [("no list", 0), ("mixed", 1), ("mixed", 128),
                                     ("empty hot list", 128), ("duplicates", 128),
                                     ("all live", 128)])
def test_k21_paths_and_tails(case, mh, offset, tail, monkeypatch):
    """The vector path (aligned, 0-7 rows of tail past the 8-row groups)
    and the scalar path (one word in) at small blocks, in scan mode, with
    rows of 0xFFFFFFFF."""
    monkeypatch.setattr(dist_plan, "IN_SET_THREADS", 64)
    g = np.random.default_rng(mh * 8 + offset * 4 + tail)
    h = g.integers(0, 2**32, 8 * 64 * 3 + tail, dtype=np.uint64).astype(np.uint32)
    h[::11] = M32
    hot = k21_list(case, g, h, mh)
    plan = check_k21(h, hot, offset, want_vec=offset == 0, want_search=False)
    assert plan.blocks * plan.threads * plan.rows >= len(h)


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("search", [False, True])
@pytest.mark.parametrize("blocks", [0, 1, 3])
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_k21_rows_modes_and_capped_grids(rows, search, blocks, offset, monkeypatch):
    """Every rows a thread in both modes, the grid covering the rows once or
    capped at 1 and 3 blocks (a thread takes several units), views 0-2
    words in: a view whose offset breaks the 4R-byte alignment takes the
    scalar path."""
    monkeypatch.setattr(dist_plan, "IN_SET_ROWS", rows)
    monkeypatch.setattr(dist_plan, "IN_SET_THREADS", 32)
    monkeypatch.setattr(dist_plan, "IN_SET_SEARCH_THREADS", 64)
    monkeypatch.setattr(dist_plan, "IN_SET_SCAN_MAX", 16)
    monkeypatch.setattr(dist_plan, "IN_SET_BLOCKS", blocks)
    g = np.random.default_rng(rows * 100 + blocks * 10 + offset)
    h = g.integers(0, 2**20, 1000 + rows + offset, dtype=np.uint64).astype(np.uint32)
    h[::13] = M32
    hot = k21_list("all live" if search else "mixed", g, h, 40 if search else 16)
    hot[::3] = M32
    plan = check_k21(h, hot, offset, want_vec=(4 * offset) % min(4 * rows, 16) == 0,
                     want_search=search)
    monkeypatch.setattr(dist_plan, "IN_SET_BLOCKS", 0)
    whole = k21_plan_of(t32(h), len(hot)).blocks
    assert plan.blocks == (min(blocks, whole) if blocks else whole)


@pytest.mark.parametrize("mh", [17, 100, 257, 1000, 4097])
@pytest.mark.parametrize("case", ["mixed", "duplicates", "all live", "empty hot list"])
def test_k21_search_mode_sorts_and_finds(case, mh, monkeypatch):
    """Lists past the scan's threshold (here 16 entries): the network sorts
    any length, powers of two and not, sentinels last; duplicates and rows
    of 0xFFFFFFFF never mismatch."""
    monkeypatch.setattr(dist_plan, "IN_SET_SCAN_MAX", 16)
    monkeypatch.setattr(dist_plan, "IN_SET_SEARCH_THREADS", 128)
    g = np.random.default_rng(mh)
    h = g.integers(0, 2**32, 1501, dtype=np.uint64).astype(np.uint32)
    h[::9] = M32
    hot = k21_list(case, g, h, mh)
    check_k21(h, hot, 0, want_vec=True, want_search=True)


@pytest.mark.parametrize("mh", [58080, 58081, dist_plan.IN_SET_MAX_HOT])
def test_k21_full_lists_with_and_without_room_to_compact(mh):
    """At 1024 threads the warps' counts (128 bytes) fit beside a list of
    up to 58,080 entries: its live entries are sorted; past that the whole
    list is, sentinels last."""
    g = np.random.default_rng(mh)
    h = g.integers(0, 2**32, 3001, dtype=np.uint64).astype(np.uint32)
    h[::17] = M32
    hot = k21_list("all live", g, h, mh)
    hot[g.random(mh) < 0.5] = M32
    plan = check_k21(h, hot, 0, want_vec=True, want_search=True)
    assert plan.threads == 1024
    assert (4 * mh + plan.threads // 8 <= dist_plan.SHARED_BYTES) == (mh <= 58080)


def test_k21_plan_at_the_path_and_past_the_scan():
    """The path's list (2 * 4 * 16 entries) is scanned by a grid that covers
    1M rows once at 8 rows a thread; a full list is searched by the blocks
    that fit 132 SMs beside it (at most one a row chunk); the refusal limit
    is the shared memory's."""
    p = dist_plan.in_set_plan(1_000_000, 128, 0, 0)
    assert p == dist_plan.InSetPlan(8, True, False, 128, 977)
    p = dist_plan.in_set_plan(1 << 20, dist_plan.IN_SET_MAX_HOT, 4, 0)
    assert (p.vec, p.search, p.threads, p.blocks) == (False, True, 1024, 128)
    p = dist_plan.in_set_plan(1 << 22, dist_plan.IN_SET_MAX_HOT, 8, 0)
    assert (p.vec, p.search, p.blocks) == (False, True, 132)
    assert dist_plan.in_set_plan(1 << 22, 1000, 0, 0).blocks == 2 * 132
    assert dist_plan.IN_SET_MAX_HOT == (dist_plan.SHARED_BYTES - 16) // 4
    with pytest.raises(ValueError, match="K21"):
        dist_plan.check_hot_list("in_hot_set", 10, dist_plan.IN_SET_MAX_HOT + 1)
    dist_plan.check_hot_list("in_hot_set", 10, dist_plan.IN_SET_MAX_HOT)


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
    # splitters past shared memory: in rounds, no refusal
    ns = dist_plan.SHARED_BYTES // 16 + 1
    spl_big = [torch.zeros(ns, dtype=torch.int32)] * 4
    assert torch.equal(range_dest([num] * 4, spl_big), range_dest_plain([num] * 4, spl_big))
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
