"""K14, the expansion sources (``csrc/expand_sources.cu``), emulated in numpy
as the card runs it, against its plain torch version and the JAX package.

The kernel merges the output positions 0 .. cap - 1 with ``c`` (the
inclusive cumsum of the multiplicities), ties to ``c``: entry j of c sits at
merge position ``j + min(c[j], cap)``, and output i takes the entries before
it, ``#{j : c[j] <= i}`` (which is nprobe past the total).  The emulation
follows ``kernels/scan_plan.expand_plan``'s plan:

- a block a run of NV = threads * items merge items;
- warps 0 and 1 find the block's first and last diagonal's split by a
  32-ary search of c, a lane a probe, the lanes whose probe lies before the diagonal a prefix of the warp
  (checked), every probe inside c (checked);
- the block's slice of c, at most NV entries, staged as the local output
  position each entry comes before (checked to lie in [0, na]);
- each thread's binary search for its diagonal in the slice, then its serial
  merge of ``items`` items, an output taking the block's first split plus
  the slice entries passed;
- every output written once (checked), by the block that owns it.

It is held against ``expand_sources_plain`` and against the sources of the
JAX package's ``materialize_field3_device`` (the probe rows' ``recid`` is
their index; a fill row has ``valid`` False), at every (threads, items)
that ``tools/expand_sweep.py`` tries.  Every value is an integer, so every
comparison is exact.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu_torch.kernels import scan_plan
from database_technology_algorithms_tpu_torch.kernels.expand_sources import (
    expand_sources, expand_sources_plain)
from database_technology_algorithms_tpu_torch.tools.expand_sweep import PLANS

jhash = importlib.import_module("database_technology_algorithms_tpu.ops.hash_join")
LANE = np.arange(32, dtype=np.int64)


def warp_split(c: np.ndarray, cap: int, d: int, stats: dict) -> int:
    """csrc/expand_sources.cu diagonal_split: #{j : j + min(c[j], cap) < d},
    by a warp's 32 lanes."""
    nprobe = len(c)
    lo, hi, steps = max(d - cap, 0), min(d, nprobe), 0
    while lo < hi:
        s = (hi - lo + 31) // 32
        p = lo + (LANE + 1) * s - 1
        inside = p < hi
        assert (p[inside] < nprobe).all()
        v = c[np.minimum(p, max(nprobe - 1, 0))].astype(np.int64)
        before = inside & (p + np.minimum(v, cap) < d)
        k = int(before.sum())
        assert before[:k].all() and not before[k:].any(), "the lanes before d are not a prefix"
        lo += k * s
        hi = min(hi, lo + s - 1)
        steps += 1
    stats["search_steps"] = max(stats["search_steps"], steps)
    return lo


def k14_emulate(c: np.ndarray, cap: int, plan) -> tuple[np.ndarray, dict]:
    """src int32[cap] as the plan's blocks and threads compute it, with the
    blocks' kinds of first item (a c entry, an output) and their splits."""
    c = np.asarray(c, np.int64)
    nprobe = len(c)
    n, nv = cap + nprobe, plan.threads * plan.items
    assert plan.blocks == -(-n // nv) and plan.shared_bytes == 8 * nv
    src = np.full(cap, -1, np.int64)
    written = np.zeros(cap, np.int64)
    stats = {"search_steps": 0, "starts": set(), "zero_output_blocks": 0,
             "all_output_blocks": 0}
    dt = np.arange(plan.threads, dtype=np.int64) * plan.items
    for k in range(plan.blocks):
        d0, d1 = k * nv, min(k * nv + nv, n)
        b0 = warp_split(c, cap, d0, stats)
        b1 = warp_split(c, cap, d1, stats)
        a0, nb, here = d0 - b0, b1 - b0, d1 - d0
        na = here - nb
        assert 0 <= nb <= nv and 0 <= na <= nv
        e = np.minimum(c[b0:b1], cap) - a0  # the slice in shared memory
        assert ((e >= 0) & (e <= na)).all()
        stats["zero_output_blocks"] += na == 0
        stats["all_output_blocks"] += nb == 0
        if k:  # the block's first item, and the item before it
            first = "entry" if nb and e[0] == 0 else "output"
            prev = "entry" if b0 and b0 - 1 + min(int(c[b0 - 1]), cap) == d0 - 1 else "output"
            stats["starts"].add(f"{first} after {prev}")
        ep = np.append(e, np.iinfo(np.int64).max)  # past the slice: never passed over
        act = dt < here  # the threads with items
        lo = np.where(act, np.maximum(dt - na, 0), 0)
        hi = np.where(act, np.minimum(dt, nb), 0)
        while (lo < hi).any():
            mid = (lo + hi) >> 1
            step = lo < hi
            go = step & (mid + ep[mid] < dt)
            lo = np.where(go, mid + 1, lo)
            hi = np.where(step & ~go, mid, hi)
        bt, at = lo.copy(), dt - lo
        end = np.minimum(dt + plan.items, here)
        out = np.full(na, -1, np.int64)
        hits = np.zeros(na, np.int64)
        for step in range(plan.items):
            live = dt + step < end
            entry = live & (bt < nb) & (ep[np.minimum(bt, nb)] <= at)
            emit = live & ~entry
            np.add.at(hits, at[emit], 1)
            out[at[emit]] = b0 + bt[emit]
            bt += entry
            at += emit
        assert (hits == 1).all(), "a block's output not written exactly once"
        src[a0:a0 + na] = out
        written[a0:a0 + na] += 1
    assert (written == 1).all(), "an output not written by exactly one block"
    return src.astype(np.int32), stats


def plan_for(monkeypatch, cap: int, nprobe: int, threads: int, items: int):
    monkeypatch.setattr(scan_plan, "EXPAND_THREADS", threads)
    monkeypatch.setattr(scan_plan, "EXPAND_ITEMS", items)
    return scan_plan.expand_plan(cap, nprobe)


def mult_case(case: str, nv: int, g) -> np.ndarray:
    if case == "no probe rows":
        return np.zeros(0, np.int32)
    if case == "every multiplicity 0":
        return np.zeros(1000, np.int32)
    if case == "one row holds every output":  # over at least three blocks
        mult = np.zeros(1000, np.int32)
        mult[333] = 3 * nv + 5
        return mult
    if case == "a zero run longer than a block":
        mult = g.integers(0, 4, 1000).astype(np.int32)
        return np.concatenate([mult[:400], np.zeros(2 * nv + 3, np.int32), mult[400:]])
    if case == "block starts on row boundaries":  # a zero row first: out j, then entry j
        return np.concatenate([[0], np.ones(3 * nv, np.int32)]).astype(np.int32)
    if case == "block starts on ties":  # c[j] = j + 1: entry j - 1 = i, then output i
        return np.ones(3 * nv, np.int32)
    n = {"random, 1000 rows": 1000, "random, 100000 rows": 100_000}[case]
    return g.integers(0, 4, n).astype(np.int32)


CASES = ["no probe rows", "every multiplicity 0", "one row holds every output",
         "a zero run longer than a block", "block starts on row boundaries",
         "block starts on ties", "random, 1000 rows", "random, 100000 rows"]
CAPS = {"cap 0": lambda t: 0, "cap below the total": lambda t: t // 2,
        "cap = total": lambda t: t, "cap above the total": lambda t: t + 37}


@functools.lru_cache(maxsize=None)
def jax_sources(mult_bytes: bytes, cap: int) -> np.ndarray:
    """The sources of the JAX package's materialize_field3_device: probe row
    j's recid is j, and a fill row (valid False) stands for nprobe."""
    mult = np.frombuffer(mult_bytes, np.int32)
    n = len(mult)
    probe = JBatch.from_numpy(np.arange(n, dtype=np.uint32), np.zeros(n, np.uint32),
                              valid=np.ones(n, bool))
    out, total = jhash.materialize_field3_device(probe, jnp.asarray(mult), cap)
    assert int(total) == int(mult.sum())
    return np.where(np.asarray(out.valid), np.asarray(out.recid).astype(np.int64), n)


def check(mult: np.ndarray, cap: int, plan, jax: bool = False) -> dict:
    c = np.cumsum(mult, dtype=np.int64).astype(np.int32)
    total = int(c[-1]) if len(c) else 0
    got, stats = k14_emulate(c, cap, plan)
    ct = torch.from_numpy(c)
    want = expand_sources_plain(ct, torch.tensor(total, dtype=torch.int32), cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        expand_sources(ct, torch.tensor(total, dtype=torch.int32), cap).numpy(), want)
    if jax and len(mult) and cap:
        np.testing.assert_array_equal(jax_sources(mult.tobytes(), cap), want)
    return stats


@pytest.mark.parametrize("cap_case", list(CAPS))
@pytest.mark.parametrize("case", CASES)
def test_k14_emulation_at_the_plan(case, cap_case, monkeypatch):
    g = np.random.default_rng(len(case) * 7 + len(cap_case))
    nv = scan_plan.EXPAND_THREADS * scan_plan.EXPAND_ITEMS
    mult = mult_case(case, nv, g)
    cap = CAPS[cap_case](int(mult.sum()))
    check(mult, cap, scan_plan.expand_plan(cap, len(mult)), jax=True)


@pytest.mark.parametrize("threads,items", PLANS)
def test_k14_emulation_at_every_swept_plan(threads, items, monkeypatch):
    g = np.random.default_rng(threads + items + 32)
    nv = threads * items
    for case in CASES[:-1]:
        mult = mult_case(case, nv, g)
        for cap_of in CAPS.values():
            cap = cap_of(int(mult.sum()))
            check(mult, cap, plan_for(monkeypatch, cap, len(mult), threads, items))


@pytest.mark.parametrize("threads,items", [(64, 4), (512, 16)])
def test_k14_heavy_row_and_zero_runs_cross_blocks(threads, items, monkeypatch):
    """One row's outputs fill whole blocks (no entry of c in them), a zero run
    fills whole blocks (no output in them), and the searches stay short."""
    g = np.random.default_rng(5)
    nv = threads * items
    for case, kind in (("one row holds every output", "all_output_blocks"),
                       ("a zero run longer than a block", "zero_output_blocks")):
        mult = mult_case(case, nv, g)
        total = int(mult.sum())
        stats = check(mult, total, plan_for(monkeypatch, total, len(mult), threads, items))
        assert stats[kind] >= 1
        assert stats["search_steps"] <= 4  # 32-ary over at most ~10^4 entries


@pytest.mark.parametrize("case,start", [("block starts on row boundaries", "entry after output"),
                                        ("block starts on ties", "output after entry")])
def test_k14_block_boundaries_on_rows_and_ties(case, start, monkeypatch):
    """Every block after the first starts on a c entry right after a row's
    last output, or on output i right after the entry c[j] = i (a tie, which
    the merge gives to c)."""
    for threads, items in ((64, 4), (128, 8)):
        nv = threads * items
        mult = mult_case(case, nv, None)
        total = int(mult.sum())
        stats = check(mult, total, plan_for(monkeypatch, total, len(mult), threads, items))
        assert stats["starts"] == {start}


@pytest.mark.parametrize("log_rows,steps", [(5, 1), (10, 2), (15, 3), (20, 4)])
def test_k14_search_steps(log_rows, steps):
    """A 32-ary search finds a block's split among 2^log_rows entries in
    ceil(log_rows / 5) dependent steps: four at a million entries, where a
    binary search an output row took 20."""
    n = 1 << log_rows
    c = np.arange(1, n + 1, dtype=np.int64)
    stats = {"search_steps": 0}
    for d in (1, 12345 % (2 * n), n, 2 * n - 1):
        b = warp_split(c, n, d, stats)
        assert b == int(((np.arange(len(c)) + np.minimum(c, n)) < d).sum())
    assert stats["search_steps"] == steps


@pytest.mark.parametrize("cap,nprobe", [((1 << 31) - 1, (1 << 31) - 1), ((1 << 31) - 1, 0),
                                        (0, (1 << 31) - 1), (3, 5)])
def test_expand_plan_counts_merge_positions_past_2_31(cap, nprobe, monkeypatch):
    """The plan alone at cap + nprobe up to 2^32 - 2: the grid covers every
    merge item once, and the last block starts past 2^31 where it must."""
    for threads, items in PLANS:
        plan = plan_for(monkeypatch, cap, nprobe, threads, items)
        nv = threads * items
        assert (plan.blocks - 1) * nv < cap + nprobe <= plan.blocks * nv
        assert plan.blocks <= (1 << 31) - 1 and plan.shared_bytes == 8 * nv
        if cap + nprobe > (1 << 32) - 3:
            assert (plan.blocks - 1) * nv > (1 << 31)


def test_expand_plan_refusals(monkeypatch):
    with pytest.raises(ValueError, match="int32"):
        scan_plan.expand_plan(1 << 31, 0)
    with pytest.raises(ValueError, match="int32"):
        scan_plan.expand_plan(0, 1 << 31)
    with pytest.raises(ValueError, match=">= 0"):
        scan_plan.expand_plan(-1, 0)
    for threads in (32, 96 + 1, 2048):
        monkeypatch.setattr(scan_plan, "EXPAND_THREADS", threads)
        with pytest.raises(ValueError, match="warps"):
            scan_plan.expand_plan(10, 10)
    monkeypatch.setattr(scan_plan, "EXPAND_THREADS", 1024)
    monkeypatch.setattr(scan_plan, "EXPAND_ITEMS", 32)
    with pytest.raises(ValueError, match="shared memory"):
        scan_plan.expand_plan(10, 10)
    with pytest.raises(ValueError, match="cap"):
        expand_sources(torch.zeros(3, dtype=torch.int32), torch.tensor(0, dtype=torch.int32), -1)
