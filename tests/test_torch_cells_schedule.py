"""The launch plan of K9 (staging into cells) and K10 (build multiplicity
over cell pairs) on the CPU.

``kernels/cells_plan.py`` holds what the wrappers hand to the CUDA kernels:
K9's span, the place kernel's warps, the shared-memory bins and the
refusals; K10's table sizing, slot layout and shared-table cap.  Here numpy
emulations run the kernels' algorithms with it, at the plan's span and at
small ones:

- K9: a count per span of its rows below the live count, the bucket-major
  matrix scanned in place, the bucket starts, clamped counts, overflow and
  sink size from it, and the place pass: each warp counts its sub-span's
  buckets, the block turns those into each warp's first place, and each
  warp walks its sub-span 32 rows a step, a row's place being its warp's
  counter plus its rank among the step's earlier lanes of its bucket; rows
  past the count are the sink's last, in row order (row i at place i), and
  are never read.
- K10: per pair a table of ``table_slots(live)`` slots, in shared memory or
  in global scratch by the plan's cap, murmur3 slots probed at triangular
  steps (1, 2, 3, ... slots on, which visit every slot), a
  one-word key held in its slot, a wider key as a 32-bit hash and a build row
  whose words are compared only on a hash match, and the compacted output.

The emulations are held against the plain versions (``stage_to_cells_plain``,
``member_multiplicity_cells_plain``) and against the JAX package
(``ops/movement.stage_to_cells``, ``ops/hash_join.member_multiplicity``) on
the same numpy inputs.  Every comparison is exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu.ops import movement as jmove
from database_technology_algorithms_tpu_torch.kernels import cells_plan
from database_technology_algorithms_tpu_torch.kernels.member_mult import (
    member_multiplicity_cells, member_multiplicity_cells_plain)
from database_technology_algorithms_tpu_torch.kernels.stage_cells import (
    stage_to_cells, stage_to_cells_plain, value_boundaries_plain)

jhash = importlib.import_module("database_technology_algorithms_tpu.ops.hash_join")
U32 = np.uint32
LANES = cells_plan.LANES


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=U32).view(np.int32))


def u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# K9 emulation


def emulate_stage(dest, active, count, nparts, cap, payloads, row_map, span, warps,
                  in_range=False, fill=0):
    """K9 as the card runs it: count, in-place scan of the bucket-major
    matrix, finish, fill (with `fill`, a u32), place (with the wrapper's K5
    ordering of the sink where destinations pass nparts and `in_range` is not
    given).  Returns
    (cells, counts, row map, overflow) as numpy arrays."""
    dest = np.asarray(dest, dtype=U32).astype(np.int64)
    n = dest.shape[0]
    nbins = nparts + 1
    live = n if count is None else min(max(int(count), 0), n)
    act = np.ones(n, bool) if active is None else np.asarray(active, bool)
    d = np.where(act, dest, nparts)
    beyond = int(((d > nparts) & (np.arange(n) < live)).sum())
    bucket = np.minimum(d, nparts)
    nspans = cells_plan.spans(n, span)
    assert cells_plan.place_bytes(nbins, warps) <= cells_plan.SHARED_BYTES

    # count: a span's histogram of its rows below the live count; the matrix
    # starts zeroed, and the rows past the count never enter it
    mat = np.zeros((nbins, nspans), np.int64)
    for s in range(nspans):
        s0, s1 = s * span, min(s * span + span, n)
        lim = min(max(live, s0), s1)
        mat[:, s] = np.bincount(bucket[s0:lim], minlength=nbins)
    # scan: K2's inclusive sum over the matrix in bucket-major order, mod 2^32
    scanned = (np.cumsum(mat.reshape(-1)) & 0xFFFFFFFF).reshape(nbins, nspans)
    flat = scanned.reshape(-1)
    # finish
    start = np.array([0 if b == 0 else flat[b * nspans - 1] for b in range(nbins)])
    total = np.array([flat[(b + 1) * nspans - 1] for b in range(nbins)]) - start
    counts = np.minimum(total[:nparts], cap)
    overflow = int(np.maximum(total[:nparts] - cap, 0).sum())
    nsink = int(total[nparts]) + n - live
    # fill: every slot holds `fill` until placed
    m = nparts * cap
    cells = [np.full(m, fill, U32) for _ in payloads]
    pays = [np.asarray(p, dtype=U32) for p in payloads]
    si = np.full(n, -1, np.int64)
    slots = np.full(n, -1, np.int64)

    def put(i, place, b):
        slot = m
        if b < nparts and place - start[b] < cap:
            slot = b * cap + (place - start[b])
            for c, p in zip(cells, pays):
                c[slot] = p[i]
        assert si[place] == -1
        si[place] = i
        slots[i] = slot

    for s in range(nspans):
        s0, s1 = s * span, min(s * span + span, n)
        lim = min(max(live, s0), s1)
        for i in range(lim, s1):  # the sink's last rows, in row order: row i at place i
            put(i, i, nparts)
        if lim == s0:
            continue
        sub = span // warps
        bounds = []
        cnt = np.zeros((warps, nbins), np.int64)
        for w in range(warps):
            w0 = min(s0 + w * sub, lim)
            w1 = min(w0 + sub, lim)
            bounds.append((w0, w1))
            cnt[w] = np.bincount(bucket[w0:w1], minlength=nbins)
            assert cnt[w].max() <= cells_plan.MAX_SPAN  # a 16-bit counter
        base = scanned[:, s] - cnt.sum(axis=0)
        run = np.cumsum(cnt, axis=0) - cnt  # each warp's first place, relative
        assert run.max() <= cells_plan.MAX_SPAN
        for w, (w0, w1) in enumerate(bounds):
            for step in range(w0, w1, LANES):
                rows = np.arange(step, min(step + LANES, w1))
                bs = bucket[rows]
                for lane, (i, b) in enumerate(zip(rows, bs)):
                    rank = int((bs[:lane] == b).sum())  # __match_any_sync & lanes below
                    put(i, base[b] + run[w, b] + rank, b)
                for b, c in zip(*np.unique(bs, return_counts=True)):
                    run[w, b] += c
    assert (si >= 0).all() and (np.sort(si) == np.arange(n)).all()
    if row_map == "si" and beyond and not in_range:
        # the wrapper orders the sink by its rows' own destination word (K5)
        sink = si[n - nsink:]
        word = np.where((np.arange(n) < live) & act, dest, nparts)[sink]
        si[n - nsink:] = sink[np.argsort(word, kind="stable")]
    out = {"slots": slots, "si": si, "none": None}[row_map]
    return cells, counts, out, overflow


def stage_inputs(case: str, n: int, nparts: int, seed: int):
    """(dest, active, count) for one case of the K9 tests."""
    g = np.random.default_rng(seed)
    dest = g.integers(0, nparts, size=n).astype(U32)
    active, count = None, None
    if case == "sink-heavy mask":  # 70% inactive
        active = g.random(n) < 0.3
    elif case == "sink-heavy count":
        count = (3 * n) // 10
    elif case == "one cell":
        dest[:] = nparts - 1
    elif case == "above nparts":
        dest = g.integers(0, nparts + 5, size=n).astype(U32)
        dest[::13] = 0xF0000000 + g.integers(0, 3, size=dest[::13].shape[0]).astype(U32)
        active = g.random(n) < 0.8
    elif case == "mask and count":
        active = g.random(n) < 0.6
        count = n // 2
    return dest, active, count


STAGE_CASES = ("uniform", "sink-heavy mask", "sink-heavy count", "one cell", "above nparts",
               "mask and count")
# (span, warps): the plan's, and small ones whose spans and steps the rows cross
GEOMETRIES = {"plan": (cells_plan.SPAN, cells_plan.PLACE_WARPS), "128x2": (128, 2),
              "64x1": (64, 1), "256x8": (256, 8)}


def run_both(dest, active, count, nparts, cap, pay, row_map, geometry, in_range=False):
    span, warps = GEOMETRIES[geometry]
    emu = emulate_stage(dest, active, count, nparts, cap, pay, row_map, span, warps, in_range)
    act_t = None if active is None else torch.from_numpy(np.asarray(active, bool))
    got = stage_to_cells(t32(dest), act_t, nparts, cap, [t32(w) for w in pay], row_map,
                         count=count, in_range=in_range)
    return emu, got


def same_stage(emu, got, row_map):
    cells, counts, rmap, overflow = emu
    assert len(got[0]) == len(cells)
    for a, b in zip(got[0], cells):
        np.testing.assert_array_equal(u32(a), b)
    np.testing.assert_array_equal(got[1].numpy(), counts)
    assert int(got[3]) == overflow
    if row_map == "none":
        assert got[2] is None and rmap is None
    else:
        np.testing.assert_array_equal(got[2].numpy(), rmap)


@pytest.mark.parametrize("row_map", ["slots", "si", "none"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("case", STAGE_CASES)
def test_stage_emulation_matches_plain_and_jax(case, geometry, row_map):
    """Every case against the plain version (the wrapper on CPU tensors) and
    JAX, at 600 rows: spans of 64-256 rows, steps of 32, a short last span."""
    n, nparts = 600, 16
    dest, active, count = stage_inputs(case, n, nparts, seed=len(case) + len(geometry))
    cap = 8 if case == "one cell" else 64  # "one cell" overflows
    pay = np.random.default_rng(3).integers(0, 2**32, size=(2, n), dtype=np.uint64)
    emu, got = run_both(dest, active, count, nparts, cap, list(pay), row_map, geometry)
    same_stage(emu, got, row_map)
    if case == "one cell":
        assert emu[3] > 0
    jact = np.ones(n, bool) if active is None else active.copy()
    if count is not None:
        jact &= np.arange(n) < count
    want = jmove.stage_to_cells(jnp.asarray(dest), jnp.asarray(jact), nparts, cap,
                                [jnp.asarray(w.astype(U32)) for w in pay], row_map)
    same_stage((list(map(np.asarray, want[0])), np.asarray(want[1]),
                None if want[2] is None else np.asarray(want[2]), int(want[3])), got, row_map)


@pytest.mark.parametrize("geometry", ["plan", "128x2", "256x8"])
@pytest.mark.parametrize("nparts", [1, 2, 16, 4096, 4097])
def test_stage_emulation_cell_counts(nparts, geometry):
    """nparts of 1 to 4097 (the tiled join's 4096 and one past), with
    destinations at and above nparts, against the plain version."""
    n = 1500
    g = np.random.default_rng(nparts)
    dest = g.integers(0, nparts + 2, size=n).astype(U32)
    active = g.random(n) < 0.9
    cap = max(2 * -(-n // nparts), 4)
    pay = [g.integers(0, 2**32, size=n, dtype=np.uint64)]
    for row_map in ("slots", "si"):
        emu, got = run_both(dest, active, None, nparts, cap, pay, row_map, geometry)
        same_stage(emu, got, row_map)
        plain = stage_to_cells_plain(t32(dest), torch.from_numpy(active), nparts, cap,
                                     [t32(pay[0])], row_map)
        same_stage(emu, plain, row_map)


@pytest.mark.parametrize("geometry", ["128x2", "64x1"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511])
def test_stage_emulation_span_and_step_edges(n, geometry):
    """Row counts on both sides of a step (32), a sub-span and a span, with
    a live count on a span edge and one inside a step."""
    span, _ = GEOMETRIES[geometry]
    g = np.random.default_rng(n)
    dest = g.integers(0, 5, size=n).astype(U32)
    pay = [g.integers(0, 2**32, size=n, dtype=np.uint64)]
    for count in (None, min(span, n), n // 2 + 1, 0):
        emu, got = run_both(dest, None, count, 5, max(n // 3, 1), pay, "si", geometry)
        same_stage(emu, got, "si")
        want = stage_to_cells_plain(t32(dest), None, 5, max(n // 3, 1), [t32(pay[0])], "si",
                                    count)
        same_stage(emu, want, "si")


@pytest.mark.parametrize("count_type", ["int", "tensor"])
def test_stage_count_form_equals_mask_form(count_type):
    """The count form is the JAX ``active`` of ``arange(n) < count``."""
    n, nparts = 900, 16
    g = np.random.default_rng(5)
    dest = t32(g.integers(0, nparts, size=n))
    pay = [t32(g.integers(0, 2**32, size=n, dtype=np.uint64))]
    c = 317
    count = c if count_type == "int" else torch.tensor(c, dtype=torch.int32)
    mask = torch.arange(n) < c
    for row_map in ("slots", "si", "none"):
        a = stage_to_cells(dest, None, nparts, 24, pay, row_map, count=count)
        b = stage_to_cells(dest, mask, nparts, 24, pay, row_map)
        for x, y in zip(a[0], b[0]):
            assert torch.equal(x, y)
        assert torch.equal(a[1], b[1]) and int(a[3]) == int(b[3])
        if row_map != "none":
            assert torch.equal(a[2], b[2])


def test_stage_in_range_promise_skips_the_sink_order():
    """Without destinations above nparts the promise changes nothing; with
    them the emulation shows the sink left in row order (the card's order),
    which is why only a caller whose destinations are masked gives it."""
    n, nparts = 400, 8
    g = np.random.default_rng(9)
    dest = g.integers(0, nparts, size=n).astype(U32)
    pay = [g.integers(0, 2**32, size=n, dtype=np.uint64)]
    emu, got = run_both(dest, None, 250, nparts, 80, pay, "si", "128x2", in_range=True)
    same_stage(emu, got, "si")
    dest[::7] = nparts + 1 + (np.arange(dest[::7].shape[0]) % 3)[::-1]
    with_order = emulate_stage(dest, None, None, nparts, 80, pay, "si", 128, 2)
    promised = emulate_stage(dest, None, None, nparts, 80, pay, "si", 128, 2, in_range=True)
    sink = slice(n - int((dest >= nparts).sum()), n)
    assert not np.array_equal(with_order[2][sink], promised[2][sink])
    assert (np.diff(promised[2][sink]) > 0).all()  # row order


def step_peers(buckets, live, sink, winners):
    """The place walk's groups of one warp step, as csrc/stage_cells.cu forms
    them: the first live lane's bucket and the sink by ballots, every other
    live lane alone unless two of them mark the same byte of s_own (the byte
    keeps the lane `winners` picks), when __match_any_sync gives them all."""
    lanes = np.nonzero(live)[0]
    if lanes.size == 0:
        return {}
    b0 = buckets[lanes[0]]
    single = [lane for lane in lanes if buckets[lane] not in (b0, sink)]
    own = {}
    for lane in single:
        own.setdefault(buckets[lane] % cells_plan.OWN_BYTES, []).append(lane)
    marks = {k: winners(v) for k, v in own.items()}
    clash = any(marks[buckets[lane] % cells_plan.OWN_BYTES] != lane for lane in single)
    peers = {}
    for lane in lanes:
        b = buckets[lane]
        if clash or b in (b0, sink):
            peers[lane] = [x for x in lanes if buckets[x] == b]
        else:
            peers[lane] = [lane]
    return peers


@pytest.mark.parametrize("case", ["uniform", "sink-heavy", "one bucket", "repeats", "aliases",
                                  "part live"])
def test_place_step_groups_are_the_match_groups(case):
    """Whatever lane wins a byte of s_own, each live lane's group is the
    lanes of its bucket (what __match_any_sync returns), so the rank among
    earlier lanes is the stable one."""
    g = np.random.default_rng(len(case))
    sink = 4096
    for trial in range(300):
        buckets = g.integers(0, sink, size=LANES)
        live = np.ones(LANES, bool)
        if case == "sink-heavy":
            buckets[g.random(LANES) < 0.7] = sink
        elif case == "one bucket":
            buckets[:] = g.integers(0, sink)
        elif case == "repeats":
            buckets = g.integers(0, 6, size=LANES)
        elif case == "aliases":  # distinct buckets on one byte of s_own
            buckets = (g.integers(0, 2, size=LANES) * cells_plan.OWN_BYTES
                       + g.integers(0, 3, size=LANES))
        elif case == "part live":
            live = g.random(LANES) < 0.5
        for winners in (min, max, lambda v: v[len(v) // 2]):
            peers = step_peers(buckets, live, sink, winners)
            for lane, group in peers.items():
                assert group == [x for x in np.nonzero(live)[0] if buckets[x] == buckets[lane]]


@pytest.mark.parametrize("n", [1, 1000])
@pytest.mark.parametrize("nprobes", [1, 17, 1025, 4097])
def test_value_boundaries_from_the_count_and_scan(nprobes, n):
    """value_boundaries is the bucket starts of the same count and scan."""
    g = np.random.default_rng(nprobes)
    d = g.integers(0, nprobes + 4, size=n).astype(U32)
    d[::9] = 0xF0000000
    nbins = nprobes + 1
    for span in (64, cells_plan.SPAN):
        mat = np.zeros((nbins, cells_plan.spans(n, span)), np.int64)
        for s in range(mat.shape[1]):
            mat[:, s] = np.bincount(np.minimum(d[s * span:(s + 1) * span], nprobes),
                                    minlength=nbins)
        flat = np.cumsum(mat.reshape(-1))
        starts = [0] + [int(flat[b * mat.shape[1] - 1]) for b in range(1, nprobes)]
        np.testing.assert_array_equal(value_boundaries_plain(t32(d), nprobes).numpy(), starts)
        np.testing.assert_array_equal(
            np.asarray(jmove.value_boundaries(jnp.asarray(d), nprobes)), starts)


def test_stage_plan():
    """The plan's numbers at the tiled join's shapes, and its refusals."""
    assert cells_plan.SPAN % (LANES * cells_plan.PLACE_WARPS) == 0
    assert cells_plan.SPAN <= cells_plan.MAX_SPAN
    assert cells_plan.place_warps(4097) == 8  # 24M + 24M: 4096 cells
    assert cells_plan.place_bytes(4097, 8) == 4 * 4097 + 8 * (2 * 4098 + cells_plan.OWN_BYTES)
    assert cells_plan.place_warps(16385) == 4  # near 100M + 100M: 16384 cells
    assert cells_plan.place_warps(cells_plan.MAX_STAGE_BINS) == 1
    assert cells_plan.place_warps(cells_plan.MAX_STAGE_BINS + 1) == 0
    assert cells_plan.check_stage("k", 24_000_000, 4096, 8792) == 8
    assert cells_plan.stage_scratch_words(24_000_000, 4096) == (
        4097 * 1465 + 2 + 2 * -(-4097 * 1465 // 4096) + 4097)
    with pytest.raises(ValueError, match="shared"):
        cells_plan.check_stage("k", 10, cells_plan.MAX_STAGE_BINS, 1)
    with pytest.raises(ValueError, match="slots"):
        cells_plan.check_stage("k", 10, 1 << 16, 1 << 16)
    with pytest.raises(ValueError, match="2\\^31"):
        cells_plan.check_stage("k", 1 << 31, 4, 4)
    with pytest.raises(ValueError, match="probes"):
        cells_plan.check_boundaries("k", 10, cells_plan.MAX_BOUNDARY_BINS)
    cells_plan.check_boundaries("k", 10, cells_plan.MAX_BOUNDARY_BINS - 1)


# ---------------------------------------------------------------------------
# K10 emulation


def table_hash(words) -> np.ndarray:
    """csrc/member_mult.cu's murmur3 over the key words, row by row."""
    return cells_plan.table_hash(np.stack([np.asarray(w, U32) for w in words], axis=-1))


def emulate_member_mult(bw, nb, kw, nk, live_k, shared, out=None, out_pos=None):
    """K10 as the card runs it; `bw` [G, cap_b, m] and `kw` [G, cap_k, m]
    u32.  Returns (counts [G, cap_k] or out, the pairs whose table was
    global)."""
    G, cap_b, m = bw.shape
    cap_k = kw.shape[1]
    res = np.zeros((G, cap_k), np.int64)
    global_pairs = []
    for g in range(G):
        nbg = min(max(int(nb[g]), 0), cap_b)
        slots = cells_plan.table_slots(nbg)
        if slots > shared:
            global_pairs.append(g)
        mask = slots - 1
        tab = [None] * slots  # one word: (count, key); m words: (hash, row) and a count
        count = [0] * slots
        bh = table_hash([bw[g, :, k] for k in range(m)])
        for i in range(nbg):
            key = tuple(bw[g, i])
            s, step = int(bh[i]) & mask, 0
            while True:
                if tab[s] is None:
                    tab[s] = (int(bh[i]), i)
                    count[s] += 1
                    break
                h, row = tab[s]
                # m words: the build row's words are read only on a hash match
                if h == int(bh[i]) and tuple(bw[g, row]) == key:
                    count[s] += 1
                    break
                step += 1
                s = (s + step) & mask
        assert sum(t is not None for t in tab) * 4 <= 3 * slots or nbg == 0
        nkg = cap_k if nk is None else min(max(int(nk[g]), 0), cap_k)
        kh = table_hash([kw[g, :, k] for k in range(m)])
        for j in range(nkg):
            if live_k is not None and not live_k[g, j]:
                continue
            s, step = int(kh[j]) & mask, 0
            while tab[s] is not None:
                h, row = tab[s]
                if h == int(kh[j]) and tuple(bw[g, row]) == tuple(kw[g, j]):
                    res[g, j] = count[s]
                    break
                step += 1
                s = (s + step) & mask
    if out is None:
        return res, global_pairs
    for g in range(G):
        nkg = min(max(int(nk[g]), 0), cap_k)
        out[out_pos[g]: out_pos[g] + nkg] = res[g, :nkg]
    return out, global_pairs


def k10_inputs(seed, G, cap_b, cap_k, m, pool_size):
    g = np.random.default_rng(seed)
    pool = g.integers(0, 2**32, size=(pool_size, m), dtype=np.uint64).astype(U32)
    bw = pool[g.integers(0, pool_size, size=(G, cap_b))]
    kw = pool[g.integers(0, pool_size, size=(G, cap_k))]
    nb = g.integers(0, cap_b + 1, size=G).astype(np.int32)
    nb[0], nb[-1] = cap_b, 0
    nk = g.integers(0, cap_k + 1, size=G).astype(np.int32)
    nk[0] = cap_k
    live = g.random((G, cap_k)) < 0.8
    return bw, kw, nb, nk, live


def plain_counts(bw, nb, kw, nk, live):
    m = bw.shape[2]
    return member_multiplicity_cells_plain(
        [t32(bw[..., j]) for j in range(m)], torch.from_numpy(nb),
        [t32(kw[..., j]) for j in range(m)], None if nk is None else torch.from_numpy(nk),
        None if live is None else torch.from_numpy(live)).numpy()


def jax_counts(bw, nb, kw, nk, live):
    G, _, m = bw.shape
    cap_k = kw.shape[1]
    out = []
    for g in range(G):
        lv = np.ones(cap_k, bool) if live is None else live[g].copy()
        if nk is not None:
            lv &= np.arange(cap_k) < nk[g]
        out.append(np.asarray(jhash.member_multiplicity(
            [jnp.asarray(bw[g, :, k]) for k in range(m)], jnp.int32(nb[g]),
            [jnp.asarray(kw[g, :, k]) for k in range(m)], jnp.asarray(lv))))
    return np.stack(out).astype(np.int64)


@pytest.mark.parametrize("form", ["n_kkeys", "live_k", "both"])
@pytest.mark.parametrize("m", [1, 2, 3, 33])
def test_member_mult_emulation_matches_plain_and_jax(m, form):
    """m = 1-3 and field 3's full key width (num + 32 string words), keys
    that repeat on both sides, n_bkeys of 0 and of cap_b, dead query rows."""
    G, cap_b, cap_k = 5, 60, 70
    bw, kw, nb, nk, live = k10_inputs(m, G, cap_b, cap_k, m, pool_size=25)
    nk_f = None if form == "live_k" else nk
    live_f = None if form == "n_kkeys" else live
    shared = cells_plan.table_cap(cap_b, m)
    emu, global_pairs = emulate_member_mult(bw, nb, kw, nk_f, live_f, shared)
    assert not global_pairs  # 60 build rows: 128 slots fit the shared table
    np.testing.assert_array_equal(emu, plain_counts(bw, nb, kw, nk_f, live_f))
    np.testing.assert_array_equal(emu, jax_counts(bw, nb, kw, nk_f, live_f))
    assert emu.max() > 1 and (emu == 0).any()


@pytest.mark.parametrize("m", [1, 3])
def test_member_mult_pair_above_the_shared_table(m):
    """A skewed pair whose live build rows need more slots than the shared
    table takes the global table; the others stay in shared memory."""
    G, cap_b, cap_k = 4, 400, 64
    bw, kw, nb, nk, live = k10_inputs(10 + m, G, cap_b, cap_k, m, pool_size=9)
    nb[:] = [400, 20, 47, 48]  # 48 rows need 64 slots, 49 need 128
    shared = cells_plan.table_cap(cap_b, m, budget=64 * cells_plan.slot_bytes(m))
    assert shared == 64
    assert cells_plan.table_scratch_words(G, cap_b, m, shared) == (
        G * 1024 * cells_plan.slot_bytes(m) // 4)
    emu, global_pairs = emulate_member_mult(bw, nb, kw, nk, live, shared)
    assert global_pairs == [0]
    np.testing.assert_array_equal(emu, plain_counts(bw, nb, kw, nk, live))
    np.testing.assert_array_equal(emu, jax_counts(bw, nb, kw, nk, live))


def test_member_mult_hash_collision_compares_the_words():
    """Two different two-word keys with the same 32-bit hash: the slot's hash
    matches and the build row's words decide."""
    g = np.random.default_rng(0)
    cand = g.integers(0, 2**32, size=(1 << 17, 2), dtype=np.uint64).astype(U32)
    h = table_hash([cand[:, 0], cand[:, 1]])
    order = np.argsort(h, kind="stable")
    dup = np.nonzero(np.diff(h[order]) == 0)[0]
    assert dup.size, "no 32-bit hash collision among 2^17 keys"
    a, b = cand[order[dup[0]]], cand[order[dup[0] + 1]]
    assert not np.array_equal(a, b)
    bw = np.stack([a, a, a, b])[None]  # 3 of a, 1 of b
    kw = np.stack([b, a, b, a, b])[None]
    nb = np.array([4], np.int32)
    emu, _ = emulate_member_mult(bw, nb, kw, None, None, 64)
    np.testing.assert_array_equal(emu, [[1, 3, 1, 3, 1]])
    np.testing.assert_array_equal(emu, plain_counts(bw, nb, kw, None, None))


@pytest.mark.parametrize("m", [1, 2])
def test_member_mult_compacted_output(m):
    """With out and out_pos (the exclusive sum of n_kkeys) the rows below
    n_kkeys land compacted, pair after pair, and nothing else is written."""
    G, cap_b, cap_k = 6, 50, 40
    bw, kw, nb, nk, live = k10_inputs(20 + m, G, cap_b, cap_k, m, pool_size=12)
    pos = (np.cumsum(nk) - nk).astype(np.int32)
    total = int(nk.sum())
    fill = np.full(total + 3, 77, np.int64)
    emu, _ = emulate_member_mult(bw, nb, kw, nk, live, cells_plan.table_cap(cap_b, m),
                                 fill.copy(), pos)
    out = torch.full((total + 3,), 77, dtype=torch.int32)
    got = member_multiplicity_cells(
        [t32(bw[..., j]) for j in range(m)], torch.from_numpy(nb),
        [t32(kw[..., j]) for j in range(m)], torch.from_numpy(nk), torch.from_numpy(live),
        out=out, out_pos=torch.from_numpy(pos))
    assert got is out
    np.testing.assert_array_equal(out.numpy(), emu)
    assert (out[total:] == 77).all()
    dense = plain_counts(bw, nb, kw, nk, live)
    np.testing.assert_array_equal(
        out[:total].numpy(), np.concatenate([dense[g, :nk[g]] for g in range(G)]))


def test_table_plan():
    """Table sizing by live rows, the shared cap by shape, and the global
    scratch only where a pair could need it."""
    assert [cells_plan.table_slots(x) for x in (0, 1, 48, 49, 1700, 3072, 3073, 8792)] == [
        64, 64, 64, 128, 4096, 4096, 8192, 16384]
    # the over-budget shape, 8792 build rows a pair, one key word: an 8192-slot
    # table of 64 KB; its ~1.7K live rows need 4096
    assert cells_plan.table_cap(8792, 1) == 8192
    assert cells_plan.table_cap(8792, 2) == 4096  # 12 bytes a slot
    assert cells_plan.table_cap(100, 1) == 256  # every pair fits: no scratch
    assert cells_plan.table_scratch_words(512, 100, 1, 256) == 0
    assert cells_plan.table_scratch_words(512, 8792, 1, 8192) == 512 * 16384 * 2
    with pytest.raises(ValueError, match="build rows"):
        cells_plan.check_table("k", cells_plan.MAX_TABLE_BUILD + 1)
