"""K17, the hash-set probe (``csrc/hash_set.cu``), emulated in numpy as the
card runs it under its plan (``engines_plan.set_probe_plan``), against its
plain torch version, exactly.

The schedule: a thread of a 256-thread block takes 2 keys, the kernel's
constants (the vector path's 2 consecutive keys and the tail's n % 2 taken
by the thread past the last whole pair, the scalar path's 2 keys a block's
width apart); both home windows of a thread
is read before any is looked at, a read takes the aligned window of W slots
that holds the next slot, and a walk goes on past a window's end and wraps
at the table's end; a thread stores its keys' flags and counts, and each
block adds its hits into the total, in any order of the blocks.

Checked: every window read aligned and inside the table, each output
written once, walks that cross a window's end and the table's end, both
windows with the evict-first hints on and off, max_probe 0, 1 and 64, a count of 0, dead rows, counts on the host and the
card, the key 0x331DA083 whose mix is EMPTY, and the total.
"""

import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu_torch.batch import u32_to_torch
from database_technology_algorithms_tpu_torch.kernels import engines_plan
from database_technology_algorithms_tpu_torch.kernels.hash_set import (
    EMPTY, HashSet, hash_set_build_plain, hash_set_probe, hash_set_probe_plain)
from database_technology_algorithms_tpu_torch.ops import hash_table as ttable

CPU = torch.device("cpu")
M32 = 0xFFFFFFFF
EMPTY_KEY = 0x331DA083  # mixes to EMPTY
EMPTY_PAIR_KEY = 0xDBDF60C1  # mixes to EMPTY ^ 1
KEYS, THREADS = 2, 256  # PROBE_KEYS and PROBE_THREADS in csrc/hash_set.cu


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


def mix(h) -> np.ndarray:
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


def thread_rows(n: int, plan, u: int) -> list:
    """The rows of thread u (a prefix of its KEYS)."""
    k, t = KEYS, THREADS
    if plan.vec:
        full = n // k
        return list(range(k * u, k * u + k)) if u < full else (
            list(range(k * full, n)) if u == full else [])
    c, lane = divmod(u, t)
    return [r for r in (c * k * t + lane + j * t for j in range(k)) if r < n]


def k17_emulate(table: np.ndarray, has_empty: bool, keys: np.ndarray, count: int,
                max_probe: int, plan, g) -> dict:
    """csrc/hash_set.cu's probe under `plan`, its blocks in a random order.
    Returns found, mult, total, the windows read, the walks that went past
    their home window and those that wrapped at the table's end, and how
    often each output was written."""
    n, size, w = len(keys), len(table), plan.window
    q = mix(keys)
    found = np.zeros(n, bool)
    mult = np.full(n, -7, np.int64)
    written = np.zeros(n, np.int64)
    out = {"reads": [], "past_window": 0, "wrapped": 0, "total": 0}
    for b in g.permutation(max(-(-n // (KEYS * THREADS)), 1)):
        for t in range(THREADS):
            rows = thread_rows(n, plan, b * THREADS + t)
            f, walk, slot, d = {}, {}, {}, {}
            for r in rows:
                live = r < count
                walk[r] = live and q[r] != EMPTY and max_probe > 0
                f[r] = live and q[r] == EMPTY and has_empty
                slot[r], d[r] = int(q[r]) & (size - 1), 0
            wins = {}
            for r in rows:  # every home window in flight together
                if walk[r]:
                    base = slot[r] - slot[r] % w
                    out["reads"].append(base)
                    wins[r] = table[base:base + w]
            for r in rows:
                first = True
                while walk[r]:
                    base = slot[r] - slot[r] % w
                    if not first:
                        out["reads"].append(base)
                    win = wins[r] if first else table[base:base + w]
                    first = False
                    settled = False
                    for s in range(slot[r] % w, w):
                        if d[r] == max_probe or win[s] == q[r] or win[s] == EMPTY:
                            f[r] = f[r] or bool(d[r] < max_probe and win[s] == q[r])
                            settled = True
                            break
                        d[r] += 1
                    if not settled and d[r] == max_probe:
                        settled = True
                    if not settled:
                        nxt = (base + w) % size
                        out["past_window"] += 1
                        out["wrapped"] += nxt < base
                        slot[r] = nxt
                    walk[r] = not settled
            for r in rows:
                out["total"] += f[r]
                found[r] = f[r]
                mult[r] = int(f[r])
                written[r] += 1
    out.update(found=found, mult=mult, written=written)
    return out


def set_plan(monkeypatch, window=4, stream=True):
    """The plan's constants, the hints on (a table past 0 bytes) or off."""
    monkeypatch.setattr(engines_plan, "SET_PROBE_WINDOW", window)
    monkeypatch.setattr(engines_plan, "SET_PROBE_STREAM_BYTES", 0 if stream else 1 << 40)


def cluster_keys(size: int, per: int = 6) -> np.ndarray:
    """`per` keys homed 2 slots before the middle of the table and as many
    2 before its end: their walks run past their home window and wrap."""
    homes = np.repeat(np.array([size // 2 - 2, size - 2]), per).astype(np.uint64)
    return inverse_mix(homes + size * np.arange(len(homes), dtype=np.uint64))


def make_case(g, size: int, n_build: int, n_probe: int):
    """A table of `size` slots built from random keys, the clusters and the
    EMPTY pair's other key; probe keys that hit, miss, walk past their home
    window and wrap, and the key whose mix is EMPTY."""
    clusters = cluster_keys(size)
    build = np.concatenate([clusters, [EMPTY_PAIR_KEY],
                            g.integers(0, 2**32, size=n_build, dtype=np.uint64)
                            .astype(np.uint32)])
    probe = np.concatenate([g.choice(build, size=n_probe // 2),
                            g.integers(0, 2**32, size=n_probe - n_probe // 2,
                                       dtype=np.uint64).astype(np.uint32)])
    probe[::29] = EMPTY_KEY
    probe[: len(clusters)] = clusters
    return build, probe


def check_probe(table_hs: HashSet, probe: np.ndarray, count, max_probe: int, g,
                offset: int = 0, want_vec=None) -> dict:
    """The emulation under the wrapper's plan for `probe` placed `offset`
    words into its buffer, against the plain version and the wrapper's
    total, exactly."""
    buf = t32(np.concatenate([np.zeros(offset, np.uint32), probe]))
    keys = buf[offset:]
    size = table_hs.slots.shape[0]
    plan = engines_plan.set_probe_plan(size, keys.data_ptr())
    if want_vec is not None:
        assert plan.vec == want_vec
    table = (table_hs.slots.numpy().view(np.uint32)).astype(np.uint64)
    n_live = len(probe) if count is None else int(count)
    em = k17_emulate(table, bool(table_hs.has_empty_key), probe, n_live, max_probe, plan, g)
    found, mult = hash_set_probe_plain(table_hs, keys, count, max_probe)
    np.testing.assert_array_equal(em["found"], found.numpy())
    np.testing.assert_array_equal(em["mult"], mult.numpy())
    assert em["total"] == int(mult.sum())
    assert (em["written"] == 1).all(), "an output written twice or never"
    for base in em["reads"]:
        assert base % plan.window == 0 and 0 <= base <= size - plan.window
    total = torch.full((), -5, dtype=torch.int32)
    f2, m2 = hash_set_probe(table_hs, keys, count, max_probe, total=total)
    assert torch.equal(f2, found) and torch.equal(m2, mult)
    assert int(total) == int(mult.sum())
    em["plan"] = plan
    return em


PLANS = [(w, st, size) for w in (1, 4) for st in (True, False) for size in (128, 256, 1024)]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: f"w{p[0]}-s{int(p[1])}-{p[2]}")
def test_k17_plans_match_plain(plan, monkeypatch):
    """Either window, the hints on and off, on three table sizes: equal to
    the plain version over several blocks, walks past their home window
    and wrapping at the table's end, the total equal to the sum of mult."""
    window, stream, size = plan
    set_plan(monkeypatch, window=window, stream=stream)
    g = np.random.default_rng(10 * window + 100 * stream + size)
    build, probe = make_case(g, size, size // 4, 1337)
    hs = hash_set_build_plain(t32(build), size, None, 64)
    assert int(hs.n_failed) == 0
    em = check_probe(hs, probe, len(probe) - 5, 64, g, want_vec=True)
    assert em["plan"].stream == stream
    assert em["wrapped"] > 0 and em["past_window"] > em["wrapped"]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("max_probe", [0, 1, 64])
def test_k17_max_probe(max_probe, window, offset, monkeypatch):
    """max_probe of 0 (only the flag), 1 (the home slot) and 64, the
    EMPTY-mix key found by the flag, on the vector and the scalar path."""
    size = 128
    set_plan(monkeypatch, window=window)
    g = np.random.default_rng(max_probe + 7 * window + 3 * offset)
    build, probe = make_case(g, size, 30, 1203)
    build = np.concatenate([build, [EMPTY_KEY]])
    hs = hash_set_build_plain(t32(build), size, None, 64)
    assert int(hs.has_empty_key) == 1
    em = check_probe(hs, probe, None, max_probe, g, offset=offset, want_vec=offset == 0)
    assert em["found"][probe == EMPTY_KEY].all()
    if max_probe == 0:
        assert em["reads"] == [] and em["found"].sum() == (probe == EMPTY_KEY).sum()
    if max_probe == 1:
        assert em["past_window"] == 0


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("count", ["zero", "dead tail", "card", "all"])
def test_k17_live_counts(count, window, offset, monkeypatch):
    """A count of 0, dead rows past the count (not found, counted nowhere),
    a count on the card and no count, on the vector and the scalar path;
    the EMPTY pair's key is in the set, 0x331DA083 is not."""
    size = 256
    set_plan(monkeypatch, window=window)
    g = np.random.default_rng(window * 10 + len(count) + 100 * offset)
    build, probe = make_case(g, size, 80, 1100)
    hs = hash_set_build_plain(t32(build), size, None, 64)
    assert int(hs.has_empty_key) == 0
    n = len(probe)
    cnt = {"zero": 0, "dead tail": n - 77, "card": torch.tensor(n - 3, dtype=torch.int32),
           "all": None}[count]
    em = check_probe(hs, probe, cnt, 64, g, offset=offset, want_vec=offset == 0)
    live = n if cnt is None else int(cnt)
    assert not em["found"][live:].any()
    assert not em["found"][probe == EMPTY_KEY].any()
    if count == "zero":
        assert em["total"] == 0 and em["reads"] == []


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("tail", [0, 1, 2, 3])
@pytest.mark.parametrize("window", [1, 4])
def test_k17_vector_path_tails_and_the_scalar_path(window, tail, offset, monkeypatch):
    """n % 4 of 0-3 on the vector path and a view one word in (the scalar
    path), with live counts, over three blocks."""
    size = 256
    set_plan(monkeypatch, window=window)
    g = np.random.default_rng(100 * window + 10 * tail + offset)
    build, _ = make_case(g, size, 60, 20)
    hs = hash_set_build_plain(t32(build), size, None, 64)
    n = 2 * KEYS * THREADS + 100 + tail
    probe = np.concatenate([g.choice(build, size=n // 2), g.integers(
        0, 2**32, size=n - n // 2, dtype=np.uint64).astype(np.uint32)])
    for count in (n, n - 7):
        check_probe(hs, probe, count, 64, g, offset=offset, want_vec=offset == 0)


def test_k17_bench_shape_at_cpu_size(monkeypatch):
    """The bench's shape (keys from 3 n / 10 values, a table about 14% full)
    under the plan's own window, the hints off."""
    n = 2000
    size = ttable.table_size_for(n)
    set_plan(monkeypatch, window=engines_plan.SET_PROBE_WINDOW, stream=False)
    g = np.random.default_rng(17)
    keys = g.integers(0, 3 * n // 10, size=n).astype(np.uint32)
    hs = hash_set_build_plain(t32(keys), size, None, 64)
    probe = g.integers(0, 3 * n // 10, size=n).astype(np.uint32)
    em = check_probe(hs, probe, None, 64, g)
    assert em["total"] == np.isin(probe, keys).sum()


def test_k17_set_probe_plan(monkeypatch):
    """The plan: a window of 4 (1 on a table under 4 slots), the vector path
    on keys aligned to 8 bytes, the keys and outputs evict-first past a 32
    MB table; its refusal."""
    assert engines_plan.set_probe_plan(1 << 21, 0) == engines_plan.SetProbePlan(4, True, False)
    assert engines_plan.set_probe_plan(1 << 23, 0).stream is False
    assert engines_plan.set_probe_plan(1 << 24, 0).stream is True
    assert engines_plan.set_probe_plan(1 << 21, 4).vec is False
    assert engines_plan.set_probe_plan(1 << 21, 8).vec is True
    assert engines_plan.set_probe_plan(2, 0).window == 1
    monkeypatch.setattr(engines_plan, "SET_PROBE_WINDOW", 2)
    with pytest.raises(ValueError, match="window"):
        engines_plan.set_probe_plan(16, 0)


def test_k17_total_argument():
    """The total: on the CPU the sum of mult, copied into the caller's 0-d
    int32 tensor (0 for no keys); any other tensor is refused."""
    hs = hash_set_build_plain(t32([1, 2, 3]), 16)
    total = torch.full((), 9, dtype=torch.int32)
    hash_set_probe(hs, t32([]), total=total)
    assert int(total) == 0
    hash_set_probe(hs, t32([1, 3, 5, 1]), total=total)
    assert int(total) == 3
    for bad in (torch.zeros(1, dtype=torch.int32), torch.zeros((), dtype=torch.int64)):
        with pytest.raises(ValueError, match="0-d int32"):
            hash_set_probe(hs, t32([1]), total=bad)
