"""The kernels of the alternative u32 engines, emulated in numpy as the card
runs them, against their plain torch versions (and, for the bucket rule,
the JAX package).

- K15 (``csrc/sorted_probe.cu``): one thread a probe row, a lower-bound
  search in the unsigned order over the live prefix of the masked keys.
- K16 (``csrc/hash_set.cu``): one thread a build key, linear probing with
  one compare-and-swap a slot, in random interleavings of the threads'
  steps; every stored key is found by K17, and a key fails exactly when it
  has tried ``engines_plan.insert_limit(max_probe)`` slots.
- K18 (``csrc/bucket_probe.cu``): one warp a bucket, its two ranges by
  binary searches of the sorted bucket columns, the overflow rule (more
  than ``cap`` rows on either side) and the compare.

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


def k15_emulate(skey: np.ndarray, bc, pkey: np.ndarray, pc) -> np.ndarray:
    """csrc/sorted_probe.cu, a thread a probe row: the count clamped to [0,
    nb], lower_bound over [0, count) in the u32 order, a hit where it lands
    on an equal key."""
    nb = len(skey)
    bc = min(max(int(bc), 0), nb)
    hit = np.zeros(len(pkey), bool)
    for i, p in enumerate(pkey.astype(np.uint64)):
        if i >= pc:
            continue
        lo, hi = 0, bc
        while lo < hi:
            mid = lo + (hi - lo) // 2
            if int(skey[mid]) < p:
                lo = mid + 1
            else:
                hi = mid
        hit[i] = lo < bc and int(skey[lo]) == p
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


# ---------------------------------------------------------------------------
# K16 and K17


def k16_emulate(keys: np.ndarray, size: int, count: int, limit: int, g) -> tuple:
    """csrc/hash_set.cu's build, one thread a live key, the threads' steps
    (one read-then-CAS of a slot each) interleaved in a random order.
    Returns (table u32[size], has_empty_key, n_failed, attempts a key)."""
    table = np.full(size, EMPTY, dtype=np.uint64)
    h = mix(keys[:count])
    has_empty = bool((h == EMPTY).any())
    slot = (h & (size - 1)).astype(np.int64)
    tries = np.zeros(count, np.int64)
    pending = [i for i in range(count) if h[i] != EMPTY]
    failed = 0
    if limit == 0:  # the loop never runs: every key to store fails
        failed, pending = len(pending), []
    while pending:
        k = int(g.integers(len(pending)))
        i = pending[k]
        cur = table[slot[i]]
        if cur == EMPTY:
            table[slot[i]] = h[i]  # the CAS succeeds
        tries[i] += 1
        if cur == EMPTY or cur == h[i]:
            pending.pop(k)
            continue
        slot[i] = (slot[i] + 1) % size
        if tries[i] == limit:
            failed += 1
            pending.pop(k)
    return table, has_empty, failed, tries


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


def k18_emulate(b_bucket, b_key, p_bucket, p_key, nbuckets: int, cap: int) -> tuple:
    """csrc/bucket_probe.cu, a warp a bucket b in [0, nbuckets]: its two
    ranges by lower bounds of b and b + 1, the overflow rule, the compare."""
    hit = np.zeros(len(p_key), bool)
    ovf = 0
    for b in range(nbuckets + 1):
        lb, hb = np.searchsorted(b_bucket, [b, b + 1], side="left")
        lp, hp = np.searchsorted(p_bucket, [b, b + 1], side="left")
        cb, cp = hb - lb, hp - lp
        if b == nbuckets or cb > cap or cp > cap:
            if b < nbuckets:
                ovf += max(cb - cap, 0) + max(cp - cap, 0)
            continue
        hit[lp:hp] = np.isin(p_key[lp:hp], b_key[lb:hb])
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
