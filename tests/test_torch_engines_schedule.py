"""The kernels of the alternative u32 engines, emulated in numpy as the card
runs them, against their plain torch versions (and, for the bucket rule,
the JAX package).

- K15 (``csrc/sorted_probe.cu``): the index launch (every S-th live key
  as a search tree in breadth-first order), then one thread a probe row:
  the tree's walk and a lower-bound search in the unsigned order of at most
  S - 1 live keys; the plan is made small through ``engines_plan`` so that
  both run at CPU sizes, and no row past the live count is read.
- K16 (``csrc/hash_set.cu``) under its plan (``engines_plan.hash_plan``):
  K keys a thread (the vector path's K consecutive keys and the tail's
  n % K taken by the thread past the last whole group, the scalar path's K
  keys a block's width apart), every home window read before any is
  looked at, a window of W slots a
  read, a compare-and-swap on a slot that read EMPTY, in random
  interleavings of the threads' steps (a window read one step, a CAS
  another); every stored key is found by K17, and a key fails exactly when
  it has tried ``engines_plan.insert_limit(max_probe)`` slots.
- K18 (``csrc/bucket_probe.cu``): the starts launch (each bucket's first
  row on both sides, every entry written once), then a block a span of
  buckets: the overflow rule (more than ``cap`` rows on either side), the
  span's build keys staged, the compare, the inactive rows.

Every value is an integer or a bool, so every comparison is exact.
"""

import importlib

import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.kernels import engines_plan
from database_technology_algorithms_tpu_torch.kernels.bucket_probe import bucket_probe_plain
from database_technology_algorithms_tpu_torch.kernels.hash_set import (
    EMPTY, HashSet, hash_set_build_plain, hash_set_probe_plain)
from database_technology_algorithms_tpu_torch.kernels.sorted_probe import sorted_probe_plain
from database_technology_algorithms_tpu_torch.ops import bucket_join as tbucket
from database_technology_algorithms_tpu_torch.ops import hash_table as ttable

jbucket = importlib.import_module("database_technology_algorithms_tpu.ops.bucket_join")
jtable = importlib.import_module("database_technology_algorithms_tpu.ops.hash_table")
CPU = torch.device("cpu")
M32 = 0xFFFFFFFF


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


def mix(h: np.ndarray) -> np.ndarray:
    h = np.asarray(h, dtype=np.uint64)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


def inverse_mix(h) -> np.ndarray:
    h = np.asarray(h, dtype=np.uint64) & M32
    h ^= h >> 16
    h = (h * 0x7ED1B41D) & M32
    h ^= (h >> 13) ^ (h >> 26)
    h = (h * 0xA5CB9243) & M32
    h ^= h >> 16
    return h.astype(np.uint32)


# ---------------------------------------------------------------------------
# K15


def k15_tree(skey: np.ndarray, bc: int, levels: int) -> tuple:
    """csrc/sorted_probe.cu's index launch: slot j of 2^levels words holds
    the live key at row tree_rank(j) * S, or U32_MAX past the index (and in
    slot 0).  Returns (tree, S, entries)."""
    stride, entries = engines_plan.probe_stride(bc, levels)
    tree = np.full(1 << levels, M32, np.uint64)
    for j in range(1, 1 << levels):
        r = engines_plan.tree_rank(j, levels)
        if r < entries:
            assert r * stride < bc  # never the padding
            tree[j] = skey[r * stride]
    return tree, stride, entries


def trailing_ones(j: np.ndarray) -> np.ndarray:
    t = np.zeros_like(j)
    x = j.copy()
    while (x & 1).any():
        t += x & 1
        x = np.where(x & 1, x >> 1, 0)
    return t


def k15_emulate(skey: np.ndarray, bc, pkey: np.ndarray, pc, levels=None) -> np.ndarray:
    """csrc/sorted_probe.cu as the card runs it, a thread a probe row: the
    count clamped to [0, nb]; the walk of the index tree (``levels`` from
    ``probe_plan``); a hit where the first index key not below the probe
    key equals it, else a lower-bound search in the u32 order of the rows
    strictly between index keys e - 1 and e, a hit where a row it reads
    equals the key (no read after the search).  Asserts that no row at or
    past the count is read."""
    nb = len(skey)
    bc = min(max(int(bc), 0), nb)
    levels = engines_plan.probe_plan(nb).levels if levels is None else levels
    tree, stride, entries = k15_tree(skey, bc, levels)
    s64 = skey.astype(np.uint64)
    p = pkey.astype(np.uint64)
    j = np.ones(len(p), np.int64)
    for _ in range(levels):
        j = 2 * j + (tree[j] < p)
    e = j - (1 << levels)
    k = j >> (trailing_ones(j) + 1)
    hit = (e < entries) & (tree[k] == p)
    assert ((k >= 1) | (e >= entries)).all()
    seg = ~hit & (e > 0)
    lo = np.where(seg, (e - 1) * stride + 1, 0)
    hi = np.where(seg, np.where(e < entries, e * stride, bc), 0)
    assert (hi - lo <= stride - 1).all()  # at most S - 1 rows
    n = hi - lo
    # the lower-bound search; a row read equal to p hits
    while (n > 0).any():
        step = n > 0
        half = n >> 1
        at = np.where(step, lo + half, 0)
        assert (at[step] < bc).all()  # never the padding
        v = s64[at] if nb else np.zeros(len(p), np.uint64)
        hit |= step & (v == p)
        less = step & (v < p)
        lo = np.where(less, lo + half + 1, lo)
        n = np.where(less, n - half - 1, np.where(step, half, n))
    hit &= np.arange(len(p)) < pc
    return hit


@pytest.mark.parametrize("nb", [0, 1, 15, 16, 17, 31, 33, 255, 257])
@pytest.mark.parametrize("count", ["all", "none", "half", "past"])
def test_k15_emulation_matches_plain(nb, count):
    g = np.random.default_rng(nb * 7 + len(count))
    pool = np.array([0, 1, 5, 0x7FFFFFFF, 0x80000000, 0xC0000000, 0xFFFFFFFE, 0xFFFFFFFF],
                    dtype=np.uint32)
    live = {"all": nb, "none": 0, "half": nb // 2, "past": nb + 5}[count]
    keys = np.sort(g.choice(pool, size=nb))
    if nb:
        keys[-1] = 0xFFFFFFFF  # a live U32_MAX at count - 1 when all are live
    nlive = min(live, nb)
    # the masked form: the live keys sorted, then the U32_MAX tail
    skey = np.concatenate([np.sort(keys[:nlive]), np.full(nb - nlive, 0xFFFFFFFF)]).astype(
        np.uint32)
    pkey = g.choice(np.append(pool, [2, 0x90000000]), size=40)
    pc = 33
    want = k15_emulate(skey, live, pkey, pc)
    hit, mult = sorted_probe_plain(t32(skey), live, t32(pkey), pc)
    np.testing.assert_array_equal(hit.numpy(), want)
    np.testing.assert_array_equal(mult.numpy(), want.astype(np.int32))
    # the set semantics: a live probe row hits iff a live build key equals it
    np.testing.assert_array_equal(want, np.isin(pkey, skey[:nlive]) & (np.arange(40) < pc))
    # with a tree of one and two levels, the search in device memory runs
    for levels in (1, 2):
        np.testing.assert_array_equal(k15_emulate(skey, live, pkey, pc, levels), want)


def k15_case(g, nb: int, count: int):
    """Sorted live keys on both sides of 2^31 with runs of equal keys, a
    live U32_MAX at count - 1, the U32_MAX tail; probes: every live key,
    its neighbours, keys past the count and random ones."""
    keys = g.integers(0, 2**32, size=nb, dtype=np.uint64).astype(np.uint32)
    keys[::5] = keys[::5] % 64 | np.uint32(1 << 31)
    keys[1::5] = keys[1::5] % 64
    live = np.sort(keys[:count])
    if count:
        live[-1] = 0xFFFFFFFF
    skey = np.concatenate([live, np.full(nb - count, 0xFFFFFFFF, np.uint32)])
    near = np.concatenate([live, live - np.uint32(1), live + np.uint32(1), keys[count:],
                           g.integers(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32),
                           np.array([0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)])
    return skey, g.permutation(near.astype(np.uint32))


@pytest.mark.parametrize("S", [4, 40, 100])
@pytest.mark.parametrize("levels", [1, 2, 3, 5])
@pytest.mark.parametrize("at", ["0", "1", "S - 1", "S", "S + 1", "E*S - 1", "E*S", "E*S + 1"])
def test_k15_two_level_search_at_the_stride_edges(levels, at, S, monkeypatch):
    """The plan made small through the module (a tree of 2^levels - 1 keys),
    so that both the tree and the search in device memory run at CPU sizes:
    counts at the stride's edges, for S and the next stride, given on the
    host and as a 0-d tensor (on the card in the kernel's callers)."""
    monkeypatch.setattr(engines_plan, "PROBE_LEVELS", levels)
    E = (1 << levels) - 1
    count = {"0": 0, "1": 1, "S - 1": S - 1, "S": S, "S + 1": S + 1, "E*S - 1": E * S - 1,
             "E*S": E * S, "E*S + 1": E * S + 1}[at]
    nb = E * S + 7
    assert engines_plan.probe_plan(nb).levels == levels
    g = np.random.default_rng(levels * 100 + count + S)
    skey, pkey = k15_case(g, nb, count)
    stride, entries = engines_plan.probe_stride(count, levels)
    assert entries <= E and (stride == 1 or -(-count // (stride - 1)) > E)
    pc = len(pkey) - 3
    want = k15_emulate(skey, count, pkey, pc)
    np.testing.assert_array_equal(want, np.isin(pkey, skey[:count]) & (np.arange(len(pkey)) < pc))
    for bc in (count, torch.tensor(count, dtype=torch.int32)):
        hit, mult = sorted_probe_plain(t32(skey), bc, t32(pkey), torch.tensor(pc))
        np.testing.assert_array_equal(hit.numpy(), want)
        np.testing.assert_array_equal(mult.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("nb", [32767 * 4 - 1, 32767 * 4 + 1, 32767 * 40 + 1])
def test_k15_default_plan_past_one_index(nb):
    """The default tree (2^15 - 1 keys) over more keys than it holds: S of
    4, 5 and 41, every live key found, its neighbours not (unless live)."""
    g = np.random.default_rng(nb)
    skey, pkey = k15_case(g, nb, nb)
    plan = engines_plan.probe_plan(nb)
    assert plan.levels == engines_plan.PROBE_LEVELS
    pkey = pkey[:20_000]
    want = k15_emulate(skey, nb, pkey, len(pkey))
    np.testing.assert_array_equal(want, np.isin(pkey, skey))
    hit, _ = sorted_probe_plain(t32(skey), None, t32(pkey))
    np.testing.assert_array_equal(hit.numpy(), want)


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 14])
def test_k15_tree_holds_the_index_in_order(levels):
    """tree_rank maps the 2^levels - 1 slots onto the sorted ranks once
    each, and an in-order walk of the tree reads the index in order."""
    n = (1 << levels) - 1
    ranks = [engines_plan.tree_rank(j, levels) for j in range(1, n + 1)]
    assert sorted(ranks) == list(range(n))
    order = []

    def walk(j):
        if j <= n:
            walk(2 * j)
            order.append(ranks[j - 1])
            walk(2 * j + 1)

    if levels <= 10:
        walk(1)
        assert order == list(range(n))


def test_k15_probe_plan(monkeypatch):
    plan = engines_plan.probe_plan(1 << 20)
    assert plan == (15, 512, 1)
    assert engines_plan.probe_grid(1 << 20, plan, 132) == 132
    monkeypatch.setattr(engines_plan, "PROBE_LEVELS", 14)
    monkeypatch.setattr(engines_plan, "PROBE_BLOCKS_PER_SM", 4)
    plan = engines_plan.probe_plan(1 << 20)
    assert (plan.levels, plan.blocks_per_sm) == (14, 3)
    assert engines_plan.probe_plan(0).levels == 1 and engines_plan.probe_plan(5).levels == 3
    assert engines_plan.probe_stride(0, 14) == (1, 0)
    assert engines_plan.probe_stride(1 << 20, 14) == (65, 16132)
    assert engines_plan.probe_stride(16383 * 64, 14) == (64, 16383)
    assert engines_plan.probe_stride(16383 * 64 + 1, 14) == (65, 16131)
    assert engines_plan.probe_stride(1 << 23, 14) == (513, 16353)
    assert engines_plan.probe_stride((1 << 31) - 1, 14)[1] <= 16383
    assert engines_plan.probe_grid(10, plan, 132) == 1
    assert engines_plan.probe_grid(1 << 20, plan, 132) == 3 * 132


# ---------------------------------------------------------------------------
# K16 and K17


def k16_threads(n: int, plan) -> list:
    """The rows of each thread of K16's grid under `plan`, a prefix of its
    K, by global thread index (an empty list for a thread with none)."""
    k, t = plan.keys, plan.threads
    out = []
    for u in range(plan.blocks * t):
        if plan.vec:
            full = n // k
            rows = list(range(k * u, k * u + k)) if u < full else (
                list(range(k * full, n)) if u == full else [])
        else:
            c, lane = divmod(u, t)
            rows = [r for r in (c * k * t + lane + j * t for j in range(k)) if r < n]
        out.append(rows)
    return out


def k16_emulate(keys: np.ndarray, size: int, count: int, limit: int, g, plan=None) -> tuple:
    """csrc/hash_set.cu's build under `plan` (by default the one the wrapper
    makes for a contiguous, aligned column), the threads' steps interleaved
    in a random order: each thread first reads every pending key's home
    window (a step each), then walks each key's window from its slot, a
    CAS on a slot that read EMPTY (a step), reading the next window (a
    step) when one is passed.  Returns (table u32[size], has_empty_key,
    n_failed, slots tried a live key)."""
    n = len(keys)
    if plan is None:
        plan = engines_plan.hash_plan(n, size, 0)
    w = plan.window
    table = np.full(size, EMPTY, dtype=np.uint64)
    h = mix(keys)
    live = np.arange(n) < count
    has_empty = bool((live & (h == EMPTY)).any())
    tries = np.zeros(n, np.int64)
    state = {"failed": 0}
    threads = k16_threads(n, plan)
    assert sorted(r for rows in threads for r in rows) == list(range(n)), "a key taken twice"
    inserts = [[r for r in rows if live[r] and h[r] != EMPTY] for rows in threads]

    def settle(r, slot, win):
        """The walk of key r from `slot` over its window `win`: yields before
        each CAS; returns (settled, next slot)."""
        base = slot - slot % w
        for s in range(slot % w, w):
            if tries[r] == limit:
                break
            cur = win[s]
            if cur == EMPTY:
                yield
                cur = table[base + s]  # the CAS: atomic, on the slot's value now
                if cur == EMPTY:
                    table[base + s] = h[r]
            if cur == EMPTY or cur == h[r]:
                return True, slot
            tries[r] += 1
        if tries[r] == limit:
            state["failed"] += 1
            return True, slot
        return False, (base + w) % size

    def run(rows):
        wins = {}
        for r in rows:  # every home window read, in flight together
            home = int(h[r]) & (size - 1)
            yield
            wins[r] = (home, table[home - home % w: home - home % w + w].copy())
        cas, nxt = {}, {}
        for r in rows:  # each key's first slot that holds it or reads EMPTY
            slot, win = wins[r]
            base = slot - slot % w
            for s in range(slot % w, w):
                if tries[r] == limit or win[s] in (h[r], EMPTY):
                    break
                tries[r] += 1
            else:
                s = w
            if s < w and tries[r] < limit and win[s] == EMPTY:
                cas[r] = base + s
            elif s < w and tries[r] < limit:
                continue  # found in the window
            elif tries[r] == limit:
                state["failed"] += 1
            else:
                nxt[r] = (base + w) % size
        won = {}
        for r, at in cas.items():  # every CAS in flight together
            yield
            won[r] = table[at]
            if won[r] == EMPTY:
                table[at] = h[r]
        for r, at in cas.items():
            if won[r] not in (EMPTY, h[r]):
                tries[r] += 1
                nxt[r] = (at + 1) % size
        for r in rows:  # the rest walk on, a window a read
            if r not in nxt:
                continue
            done, slot = False, nxt[r]
            while not done:
                yield
                win = table[slot - slot % w: slot - slot % w + w].copy()
                done, slot = yield from settle(r, slot, win)

    running = [run(rows) for rows in inserts if rows]
    while running:
        k = int(g.integers(len(running)))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    return table, has_empty, state["failed"], tries[:count]


def k17_emulate(table: np.ndarray, has_empty: bool, keys: np.ndarray, count: int,
                max_probe: int) -> np.ndarray:
    size = len(table)
    found = np.zeros(len(keys), bool)
    for i, q in enumerate(mix(keys)):
        if i >= count:
            continue
        if q == EMPTY:
            found[i] = has_empty
            continue
        s = int(q) & (size - 1)
        for _ in range(max_probe):
            if table[s] == q:
                found[i] = True
                break
            if table[s] == EMPTY:
                break
            s = (s + 1) % size
    return found


def hash_set_of(table: np.ndarray, has_empty: bool) -> HashSet:
    return HashSet(t32(table), torch.tensor(int(has_empty), dtype=torch.int32),
                   torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("order", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["uniform", "duplicates", "empty pair", "half load", "full"])
def test_k16_orders_store_the_set_and_k17_finds_it(case, order):
    g = np.random.default_rng(100 + order)
    n = 300
    keys = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    size = ttable.table_size_for(n)
    if case == "duplicates":
        keys = g.choice(keys[:40], size=n)
    elif case == "empty pair":
        keys[::50] = 0x331DA083  # mixes to EMPTY
        keys[1::50] = 0xDBDF60C1  # mixes to EMPTY ^ 1
    elif case == "half load":
        size = 2 * n
        size = 1 << (size - 1).bit_length()
    elif case == "full":
        size = 1 << (n - 1).bit_length()  # load above 0.5: longer chains
    count = n - 17
    table, has_empty, failed, tries = k16_emulate(keys, size, count, 64, g)
    assert failed == 0 and tries.max() <= 64
    plain = hash_set_build_plain(t32(keys), size, count, 64)
    assert int(plain.n_failed) == 0 and bool(plain.has_empty_key) == has_empty
    # the order changes the layout, never the set
    np.testing.assert_array_equal(np.sort(torch_to_u32(plain.slots)), np.sort(table))
    probes = np.concatenate([keys, g.integers(0, 2**32, size=100, dtype=np.uint64)
                            .astype(np.uint32), [0x331DA083, 0xDBDF60C1]])
    want = np.isin(probes, keys[:count]) & (np.arange(len(probes)) < len(probes) - 3)
    for hs, tab, he in ((plain, torch_to_u32(plain.slots), bool(plain.has_empty_key)),
                        (hash_set_of(table, has_empty), table, has_empty)):
        found, mult = hash_set_probe_plain(hs, t32(probes), len(probes) - 3, 64)
        np.testing.assert_array_equal(found.numpy(), want)
        np.testing.assert_array_equal(
            k17_emulate(tab, he, probes, len(probes) - 3, 64), want)


@pytest.mark.parametrize("limit", [0, 1, 2, 8, 64])
@pytest.mark.parametrize("nkeys", [1, 8, 64, 65, 130])
def test_k16_fails_exactly_past_the_bound(nkeys, limit):
    """nkeys distinct keys sharing one home slot, nothing near it: in any
    order the first `limit` to arrive take slots home .. home + limit - 1,
    and every other key fails after exactly `limit` tries."""
    g = np.random.default_rng(nkeys * 100 + limit)
    size = ttable.table_size_for(nkeys)
    keys = inverse_mix(9 + size * np.arange(nkeys, dtype=np.uint64))
    for _ in range(3):
        table, _, failed, tries = k16_emulate(keys, size, nkeys, limit, g)
        assert failed == max(nkeys - limit, 0)
        assert tries.max() <= limit
        assert (table != EMPTY).sum() == min(nkeys, limit)
    plain = hash_set_build_plain(t32(keys), size, None, limit)
    assert int(plain.n_failed) == failed
    assert int((plain.slots != -1).sum()) == min(nkeys, limit)


K16_PLANS = [(k, w) for k in (1, 2, 4, 8) for w in (1, 4)]


def k16_plan(monkeypatch, keys: int, window: int, threads: int = 64) -> None:
    monkeypatch.setattr(engines_plan, "HASH_KEYS", keys)
    monkeypatch.setattr(engines_plan, "HASH_WINDOW", window)
    monkeypatch.setattr(engines_plan, "HASH_THREADS", threads)


def check_k16(keys: np.ndarray, size: int, count: int, limit: int, offset: int, g,
              want_vec=None, count_on_card: bool = False) -> tuple:
    """K16's emulation under the wrapper's plan for `keys` placed `offset`
    words into their buffer, against the plain version (set, flag and
    failures) and K17's emulation (every stored key found).  Returns the
    emulation's (table, has_empty, failed, tries)."""
    buf = t32(np.concatenate([np.zeros(offset, np.uint32), keys]))
    k_t = buf[offset:]
    plan = engines_plan.hash_plan(len(keys), size, k_t.data_ptr())
    if want_vec is not None:
        assert plan.vec == want_vec
    table, has_empty, failed, tries = k16_emulate(keys, size, count, limit, g, plan)
    assert tries.max(initial=0) <= limit
    cnt = torch.tensor(count, dtype=torch.int32) if count_on_card else count
    plain = hash_set_build_plain(k_t, size, cnt, limit)
    assert int(plain.n_failed) == failed and bool(plain.has_empty_key) == has_empty
    stored = table[table != EMPTY]
    assert len(np.unique(stored)) == len(stored), "a key stored twice"
    if failed == 0:
        np.testing.assert_array_equal(np.sort(torch_to_u32(plain.slots)), np.sort(table))
        np.testing.assert_array_equal(np.sort(stored), np.unique(
            mix(keys[:count])[mix(keys[:count]) != EMPTY]))
    else:
        assert len(stored) == int((plain.slots != -1).sum())
    found = k17_emulate(table, has_empty, keys, len(keys), limit)
    want = np.isin(mix(keys), stored) | ((mix(keys) == EMPTY) & has_empty)
    np.testing.assert_array_equal(found, want)
    return table, has_empty, failed, tries


@pytest.mark.parametrize("plan", K16_PLANS, ids=lambda p: f"k{p[0]}-w{p[1]}")
@pytest.mark.parametrize("case", ["uniform", "bench range", "empty key", "all equal",
                                  "last window"])
def test_k16_plans_store_the_set_and_k17_finds_it(case, plan, monkeypatch):
    """Every keys a thread and window: random keys, the bench's
    duplicates (keys from 3 n / 10 values), the key whose mix is EMPTY and
    its pair, every key equal, and keys crowding the table's last window so
    that their walks wrap to slot 0."""
    k16_plan(monkeypatch, *plan)
    g = np.random.default_rng(sum(map(ord, case)) + 10 * plan[0] + plan[1])
    n = 397
    size = ttable.table_size_for(n)
    keys = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    if case == "bench range":
        keys = g.integers(0, 3 * n // 10, size=n).astype(np.uint32)
    elif case == "empty key":
        keys[::40] = 0x331DA083  # mixes to EMPTY
        keys[1::40] = 0xDBDF60C1  # mixes to EMPTY ^ 1
    elif case == "all equal":
        keys[:] = 12345
    elif case == "last window":  # homes at the last 3 slots, 2 copies each
        keys[:60] = np.repeat(inverse_mix(size - 3 + np.arange(30, dtype=np.uint64) % 3
                                          + size * np.arange(30, dtype=np.uint64)), 2)
    table, _, failed, tries = check_k16(keys, size, n - 5, 64, 0, g, want_vec=True)
    assert failed == 0
    if case == "last window":
        assert (table[:20] != EMPTY).sum() >= 20 and tries.max() >= 29


@pytest.mark.parametrize("keys_a_thread", [1, 2, 4, 8])
@pytest.mark.parametrize("case", ["bench range", "empty key", "all equal", "last window",
                                  "one home slot"])
def test_k16_warp_blocks(case, keys_a_thread, monkeypatch):
    """Blocks of one warp, windows of 4, every keys a thread: the same set,
    flag and failures as the plain version; keys on one home slot, every
    copy live, fail past 8."""
    k16_plan(monkeypatch, keys_a_thread, 4, threads=32)
    g = np.random.default_rng(sum(map(ord, case)) + keys_a_thread)
    n = 301
    size = ttable.table_size_for(n)
    keys = g.integers(0, 3 * n // 10, size=n).astype(np.uint32)
    limit = 64
    if case == "empty key":
        keys[::40] = 0x331DA083
    elif case == "all equal":
        keys[:] = 99
    elif case == "last window":
        keys[:60] = np.repeat(inverse_mix(size - 2 + np.arange(30, dtype=np.uint64) % 2
                                          + size * np.arange(30, dtype=np.uint64)), 2)
    elif case == "one home slot":
        keys = np.tile(inverse_mix(7 + size * np.arange(20, dtype=np.uint64)), 5)
        limit = 8
    count = len(keys) if case == "one home slot" else len(keys) - 1  # every copy live
    for _ in range(2):
        _, _, failed, _ = check_k16(keys, size, count, limit, 0, g)
        assert failed == (5 * 12 if case == "one home slot" else 0)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tail", [0, 1, 2, 3])
@pytest.mark.parametrize("keys_a_thread", [4, 8])
def test_k16_vector_path_tails_and_the_scalar_path(keys_a_thread, tail, offset, monkeypatch):
    """n % 4 of 0-3 on the vector path and a view one word in (the scalar
    path), with a live count on the host and on the card."""
    k16_plan(monkeypatch, keys_a_thread, 4, threads=32)
    g = np.random.default_rng(100 * keys_a_thread + 10 * tail + offset)
    n = 8 * 32 * 2 + tail
    size = ttable.table_size_for(n)
    keys = g.integers(0, 3 * n // 10, size=n).astype(np.uint32)
    for count, on_card in ((n, False), (n - 7, True), (n // 3, False)):
        check_k16(keys, size, count, 64, offset, g, want_vec=offset == 0, count_on_card=on_card)


@pytest.mark.parametrize("plan", K16_PLANS, ids=lambda p: f"k{p[0]}-w{p[1]}")
@pytest.mark.parametrize("limit", [8, 64])
def test_k16_plans_fail_exactly_past_the_bound(plan, limit, monkeypatch):
    """100 keys on one home slot, then 20 keys of 5 copies each (20 apart, so
    copies meet in one warp): past `limit` slots a key fails, every copy of
    it counted, in any order and under every plan."""
    k16_plan(monkeypatch, *plan, threads=32)
    g = np.random.default_rng(limit + 10 * plan[0] + plan[1])
    size = 128
    distinct = inverse_mix(9 + size * np.arange(100, dtype=np.uint64))
    copies = np.tile(distinct[:20], 5)
    for keys, want in ((distinct, max(100 - limit, 0)), (copies, 5 * max(20 - limit, 0))):
        for _ in range(2):
            table, _, failed, _ = check_k16(keys, size, len(keys), limit, 0, g)
            assert failed == want
            assert (table != EMPTY).sum() == min(limit, len(np.unique(keys)))


def test_k16_hash_plan(monkeypatch):
    plan = engines_plan.hash_plan(1 << 20, 1 << 21, 0)
    assert plan == engines_plan.HashPlan(1, 256, 4, True, 4096)
    assert engines_plan.hash_plan(1 << 20, 1 << 21, 4).vec is True  # 4-byte loads
    assert engines_plan.hash_plan(5, 2, 0).window == 1
    monkeypatch.setattr(engines_plan, "HASH_KEYS", 4)
    assert engines_plan.hash_plan(1 << 20, 1 << 21, 4).vec is False
    assert engines_plan.hash_plan(1 << 20, 1 << 21, 0).blocks == 1024
    assert engines_plan.hash_plan(0, 16, 0).blocks == 1
    monkeypatch.setattr(engines_plan, "HASH_KEYS", 2)
    assert engines_plan.hash_plan(1 << 20, 1 << 21, 8).vec is True
    assert engines_plan.hash_plan(1 << 20, 1 << 21, 4).vec is False
    monkeypatch.setattr(engines_plan, "HASH_KEYS", 3)
    with pytest.raises(ValueError, match="keys a thread"):
        engines_plan.hash_plan(10, 16, 0)
    monkeypatch.setattr(engines_plan, "HASH_KEYS", 4)
    monkeypatch.setattr(engines_plan, "HASH_WINDOW", 2)
    with pytest.raises(ValueError, match="window"):
        engines_plan.hash_plan(10, 16, 0)
    monkeypatch.setattr(engines_plan, "HASH_WINDOW", 4)
    monkeypatch.setattr(engines_plan, "HASH_THREADS", 48)
    with pytest.raises(ValueError, match="whole"):
        engines_plan.hash_plan(10, 16, 0)


@pytest.mark.parametrize("max_probe", [0, 1, 3, 64, 100])
def test_insert_limit_keeps_every_stored_key_in_probe_reach(max_probe):
    """A key stored by K16 under insert_limit(max_probe) is found by K17
    under max_probe: stored keys sit fewer slots from home than the limit."""
    g = np.random.default_rng(max_probe)
    limit = engines_plan.insert_limit(max_probe)
    assert limit == max(min(64, max_probe), 0)
    size = 64
    keys = np.concatenate([inverse_mix(5 + size * np.arange(12, dtype=np.uint64)),
                           g.integers(0, 2**32, size=10, dtype=np.uint64).astype(np.uint32)])
    table, has_empty, failed, _ = k16_emulate(keys, size, len(keys), limit, g)
    stored = np.isin(mix(keys), table)
    found = k17_emulate(table, has_empty, keys, len(keys), max_probe)
    np.testing.assert_array_equal(found, stored)
    assert failed == (~stored).sum()


@pytest.mark.parametrize("case", ["random", "bit 31", "empty pair", "one home slot"])
def test_build_and_probe_hash_set_match_jax(case):
    """The port's ``_mix``, ``build_hash_set`` and ``probe_hash_set`` against
    the JAX package's: the same mixes, failures in both or in neither and,
    where no key fails, the same membership (the JAX table differs only on
    the EMPTY pair, which these keys keep apart: only one of the two is
    built, and the other is not probed)."""
    import jax.numpy as jnp

    g = np.random.default_rng(len(case))
    n = 200
    keys = g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    size = ttable.table_size_for(n)
    if case == "bit 31":
        keys |= np.uint32(1 << 31)
    elif case == "empty pair":
        keys[::20] = 0x331DA083
    elif case == "one home slot":
        keys[:90] = inverse_mix(4 + size * np.arange(90, dtype=np.uint64))
    probes = np.concatenate([keys, g.integers(0, 2**32, size=50, dtype=np.uint64)
                             .astype(np.uint32)])
    np.testing.assert_array_equal(torch_to_u32(ttable._mix(t32(keys))),
                                  np.asarray(jtable._mix(jnp.asarray(keys))))
    jt, jf = jtable.build_hash_set(jnp.asarray(keys), size, count=jnp.int32(n - 7))
    hs, tf = ttable.build_hash_set(t32(keys), size, count=n - 7)
    if case == "one home slot":
        # at least the 26 past 64; which others fail hangs on the order
        assert int(tf) >= 26 and int(jf) >= 26
    else:
        assert int(tf) == int(jf) == 0
        want = np.asarray(jtable.probe_hash_set(jt, jnp.asarray(probes),
                                                count=jnp.int32(n + 40)))
        got = ttable.probe_hash_set(hs, t32(probes), count=n + 40)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, np.isin(probes, keys[: n - 7])
                                      & (np.arange(n + 50) < n + 40))


# ---------------------------------------------------------------------------
# K18


def k18_starts(col: np.ndarray, nbuckets: int) -> np.ndarray:
    """csrc/bucket_probe.cu's starts launch on one side: row i (and the row
    past the end) writes every bucket in (col[i-1], col[i]] (the end: up to
    nbuckets + 1).  Asserts that each entry is written exactly once."""
    n = len(col)
    c = col.astype(np.int64)
    lo = np.concatenate([[0], c + 1])
    hi = np.concatenate([c, [nbuckets + 1]])
    lo, hi = np.maximum(lo, 0), np.minimum(hi, nbuckets + 1)
    width = np.maximum(hi - lo + 1, 0)
    bucket = np.repeat(lo, width) + (np.arange(width.sum()) - np.repeat(np.cumsum(width) - width,
                                                                        width))
    row = np.repeat(np.arange(n + 1), width)
    assert np.array_equal(np.sort(bucket), np.arange(nbuckets + 2))  # each entry once
    starts = np.empty(nbuckets + 2, np.int64)
    starts[bucket] = row
    return starts


def k18_emulate(b_bucket, b_key, p_bucket, p_key, nbuckets: int, cap: int,
                span=None) -> tuple:
    """csrc/bucket_probe.cu as the card runs it: the starts launch on both
    sides, then a block a span of ``span`` buckets (``bucket_plan``'s):
    the overflow rule a bucket (one add a bucket that overflows), the kept
    build keys staged (one range when none of the span overflows, else
    bucket by bucket), each probe row of the span compared with its own
    bucket's keys, the inactive rows' hits written by the blocks in turn.
    Asserts that every hit is written exactly once and that no block holds
    more than span * cap keys."""
    span = engines_plan.bucket_plan().span if span is None else span
    nb, npr = len(b_bucket), len(p_bucket)
    st_b, st_p = k18_starts(b_bucket, nbuckets), k18_starts(p_bucket, nbuckets)
    hit = np.zeros(npr, bool)
    writes = np.zeros(npr, np.int64)
    ovf = 0
    for b0 in range(0, nbuckets, span):
        nspan = min(span, nbuckets - b0)
        lb, hb = st_b[b0:b0 + nspan], st_b[b0 + 1:b0 + nspan + 1]
        lp, hp = st_p[b0:b0 + nspan], st_p[b0 + 1:b0 + nspan + 1]
        cb, cp = hb - lb, hp - lp
        over = (cb > cap) | (cp > cap)
        ovf += int((np.maximum(cb - cap, 0) + np.maximum(cp - cap, 0))[over].sum())
        kept = np.where(over, 0, cb)
        off = np.cumsum(kept) - kept
        total = int(kept.sum())
        assert total <= span * max(cap, 1)
        if not over.any():
            keys = b_key[lb[0]:lb[0] + total]
        else:
            keys = np.zeros(total, b_key.dtype)
            for k in np.flatnonzero(~over):
                keys[off[k]:off[k] + cb[k]] = b_key[lb[k]:hb[k]]
        for i in range(lp[0], hp[-1]):
            k = p_bucket[i] - b0
            h = not over[k] and bool((keys[off[k]:off[k] + cb[k]] == p_key[i]).any())
            hit[i] = h
            writes[i] += 1
    writes[st_p[nbuckets]:] += 1  # bucket nbuckets: no hit
    assert (writes == 1).all()
    return hit, ovf


def sorted_buckets(g, n: int, nbuckets: int, heavy=(), inactive: int = 0) -> np.ndarray:
    b = g.integers(0, nbuckets, size=n)
    for bucket, rows in heavy:
        b[:rows] = bucket
        b = g.permutation(b)
    b = np.sort(b)
    if inactive:
        b[n - inactive:] = nbuckets
    return np.sort(b).astype(np.int32)


@pytest.mark.parametrize("cap", [1, 4, 128])
@pytest.mark.parametrize("case", ["uniform", "build overflow", "probe overflow", "both",
                                  "inactive tail", "empty build", "empty probe", "one bucket"])
def test_k18_emulation_matches_plain(case, cap):
    g = np.random.default_rng(len(case) * 10 + cap)
    nbuckets = 1 if case == "one bucket" else 16
    nb = 0 if case == "empty build" else 300
    npr = 0 if case == "empty probe" else 400
    heavy_b = [(3, cap + 5)] if case in ("build overflow", "both") else []
    heavy_p = [(5, cap + 9)] if case in ("probe overflow", "both") else []
    inactive = 50 if case == "inactive tail" else 0
    b_bucket = sorted_buckets(g, nb, nbuckets, heavy_b, inactive)
    p_bucket = sorted_buckets(g, npr, nbuckets, heavy_p, inactive)
    b_key = (g.integers(0, 40, size=nb) | np.where(g.random(nb) < 0.3, 1 << 31, 0)).astype(
        np.uint32)
    p_key = (g.integers(0, 40, size=npr) | np.where(g.random(npr) < 0.3, 1 << 31, 0)).astype(
        np.uint32)
    want_hit, want_ovf = k18_emulate(b_bucket, b_key, p_bucket, p_key, nbuckets, cap)
    hit, ovf = bucket_probe_plain(torch.from_numpy(b_bucket), t32(b_key),
                                  torch.from_numpy(p_bucket), t32(p_key), nbuckets, cap)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    assert int(ovf) == want_ovf
    if case in ("build overflow", "probe overflow", "both"):
        assert want_ovf > 0
    for span in (1, 3, engines_plan.BUCKET_MAX_SPAN):  # spans that cut the buckets otherwise
        got_hit, got_ovf = k18_emulate(b_bucket, b_key, p_bucket, p_key, nbuckets, cap, span)
        np.testing.assert_array_equal(got_hit, want_hit)
        assert got_ovf == want_ovf


def k18_side(g, n: int, nbuckets: int, kind: str) -> tuple:
    """A sorted bucket column and its keys: ``sparse`` (n rows over many
    buckets, most empty, the first live one above 0), ``inactive`` (every
    row in bucket nbuckets), ``empty``, ``dense``."""
    if kind == "empty":
        b = np.zeros(0, np.int64)
    elif kind == "inactive":
        b = np.full(n, nbuckets)
    elif kind == "sparse":
        b = np.sort(g.integers(nbuckets // 3, nbuckets, size=n))
        b[-n // 10:] = nbuckets
    else:
        b = np.sort(g.integers(0, nbuckets, size=n))
    keys = (g.integers(0, 32, size=len(b)) | np.where(g.random(len(b)) < 0.5, 1 << 31, 0))
    return np.sort(b).astype(np.int32), keys.astype(np.uint32)


@pytest.mark.parametrize("build", ["sparse", "inactive", "empty", "dense"])
@pytest.mark.parametrize("probe", ["sparse", "inactive", "empty", "dense"])
def test_k18_starts_and_compare_on_sparse_columns(build, probe):
    """The starts launch over sparse columns (most buckets empty, the first
    live one above 0, a run of empty buckets longer than a warp), all rows
    inactive and an empty side: each entry written once and equal to the
    bucket's first row; the compare against the plain version."""
    g = np.random.default_rng(len(build) * 31 + len(probe))
    nbuckets = 4096
    b_bucket, b_key = k18_side(g, 700, nbuckets, build)
    p_bucket, p_key = k18_side(g, 900, nbuckets, probe)
    for col in (b_bucket, p_bucket):
        np.testing.assert_array_equal(k18_starts(col, nbuckets),
                                      np.searchsorted(col, np.arange(nbuckets + 2)))
    want_hit, want_ovf = k18_emulate(b_bucket, b_key, p_bucket, p_key, nbuckets, 128)
    hit, ovf = bucket_probe_plain(torch.from_numpy(b_bucket), t32(b_key),
                                  torch.from_numpy(p_bucket), t32(p_key), nbuckets, 128)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    assert int(ovf) == want_ovf == 0


@pytest.mark.parametrize("side", ["build", "probe", "both"])
@pytest.mark.parametrize("where", ["span's first bucket", "mid-span", "span's last bucket",
                                   "two in a span"])
def test_k18_overflow_inside_a_span(side, where):
    """A bucket past cap among buckets that are not: it adds its rows past
    cap once, its probe rows get no hit, and the span's kept build keys are
    staged bucket by bucket around it."""
    g = np.random.default_rng(len(side) * 7 + len(where))
    nbuckets, cap, span = 64, 8, 16
    heavy = {"span's first bucket": [16], "mid-span": [21], "span's last bucket": [31],
             "two in a span": [17, 30]}[where]
    cols = []
    for s_name in ("build", "probe"):
        b = g.integers(0, nbuckets, size=200)
        if side in (s_name, "both"):
            b = np.concatenate([b] + [np.full(cap + 3 + h % 5, h) for h in heavy])
        cols.append((np.sort(b).astype(np.int32),
                     g.integers(0, 12, size=len(b)).astype(np.uint32)))
    (b_bucket, b_key), (p_bucket, p_key) = cols
    want_hit, want_ovf = k18_emulate(b_bucket, b_key, p_bucket, p_key, nbuckets, cap, span)
    hit, ovf = bucket_probe_plain(torch.from_numpy(b_bucket), t32(b_key),
                                  torch.from_numpy(p_bucket), t32(p_key), nbuckets, cap)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    assert int(ovf) == want_ovf > 0
    got_hit, got_ovf = k18_emulate(b_bucket, b_key, p_bucket, p_key, nbuckets, cap)
    np.testing.assert_array_equal(got_hit, want_hit)  # the plan's span, 32
    assert got_ovf == want_ovf
    for h in heavy:  # the overflowing bucket's probe rows: no hit
        assert not want_hit[p_bucket == h].any()


def test_k18_bucket_plan():
    assert engines_plan.bucket_plan() == (32, 128)
    assert engines_plan.bucket_starts_words(65536) == 2 * 65538


@pytest.mark.parametrize("n", [1, 16, 17, 255, 256, 257, 1000])
@pytest.mark.parametrize("skew", ["uniform", "all equal"])
def test_bucketed_matched_matches_jax(n, skew):
    """The port's ``_bucketed_matched`` (K8, K1, K18, K7 in their plain
    versions) against the JAX package's padded table: the same matches in
    probe order and the same overflow count."""
    import jax.numpy as jnp

    g = np.random.default_rng(n + len(skew))
    bkey = g.integers(0, max(n // 2, 1), size=n).astype(np.uint32)
    if skew == "all equal":
        bkey[:] = 7
    bkey[::7] |= np.uint32(1 << 31)
    pkey = g.integers(0, max(n // 2, 1), size=n + 3).astype(np.uint32)
    b_act = np.arange(n) < n - n // 5
    p_act = np.arange(n + 3) < n
    jm, jo = jbucket._bucketed_matched(jnp.asarray(bkey), jnp.asarray(b_act),
                                       jnp.asarray(pkey), jnp.asarray(p_act))
    tm, to = tbucket._bucketed_matched(t32(bkey), torch.from_numpy(b_act), t32(pkey),
                                       torch.from_numpy(p_act))
    assert int(to) == int(jo)
    if int(jo) == 0:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tm.numpy(), np.isin(pkey, bkey[b_act]) & p_act)


# ---------------------------------------------------------------------------
# the plan's refusals


def test_engines_plan_refusals():
    with pytest.raises(ValueError, match="power of two"):
        engines_plan.check_table("t", 48)
    with pytest.raises(ValueError, match="power of two"):
        engines_plan.check_table("t", 1 << 32)
    engines_plan.check_table("t", 1 << 31)
    with pytest.raises(ValueError, match="at most 128"):
        engines_plan.check_buckets("b", 16, 129)
    with pytest.raises(ValueError, match="buckets"):
        engines_plan.check_buckets("b", 0, 8)
    with pytest.raises(ValueError, match="int32"):
        engines_plan.check_rows("r", 1 << 31)
    assert engines_plan.insert_limit(1000) == 64 and engines_plan.insert_limit(-3) == 0
    assert tbucket._bucket_layout(8_000_000)[:2] == (524288, engines_plan.BUCKET_MAX_CAP)
    assert tbucket._bucket_layout(1 << 20)[0] == 65536
    for n in (0, 1, 16, 17, 100_000):
        assert tbucket._bucket_layout(n) == jbucket._bucket_layout(n)
