"""The plain versions of K11 (tile copy) and K12 (row move) against the
repository's two Pallas kernels, run in interpret mode on the CPU.

The Pallas kernels live in probe scripts (``tools/bench_pallas_dma.py``
``make_kernel``, ``tools/bench_permute_prims.py`` ``make_rowmove``), loaded
here by file path; the module globals the row move reads (N, T) are set on
the loaded module.  Inputs are made from a seed with numpy; every value is a
u32 word, so every comparison is exact (tolerance: max abs err 0).  The
global form of K12 (one tile spanning all rows, the placement route's
gather) and the argument checks of K11 are held against numpy.

K11's kernel (``csrc/tile_copy.cu``) is emulated under its plan
(``kernels/tile_copy.py``): a persistent grid whose blocks take units from
the call's own counter (zeroed by the entry before the launch), interleaved
in a seeded random order; each block's ring of unit buffers and their
barriers' phases, the chunk parts of a unit stored as one bulk group, a
buffer reloaded only once ``wait_group.read 1`` has retired the stores that
read it, and a tile's start read again only when a block's unit lies in
another tile than its last.  Two calls' blocks interleaved (two streams)
and a call after a launch that stopped midway each copy every unit.  A
store copies its buffer when it retires, so a buffer reloaded too early
gives a wrong result, not only a failed assertion.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.kernels.row_move import row_move, row_move_plain
from database_technology_algorithms_tpu_torch.kernels import tile_copy as k11
from database_technology_algorithms_tpu_torch.kernels.tile_copy import (
    bulk_copies, tile_copy, tile_copy_plain)
from database_technology_algorithms_tpu_torch.tools import bench_pallas_dma as tdma
from database_technology_algorithms_tpu_torch.tools import bench_permute_prims as tprims

TOOLS = Path(__file__).resolve().parent.parent / "tools"
CPU = torch.device("cpu")


def load_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pallas_dma():
    return load_tool("bench_pallas_dma")


@pytest.fixture(scope="module")
def permute_prims():
    mod = load_tool("bench_permute_prims")
    mod.N, mod.T = 4096, 512  # a small shape, as its --cpu mode makes
    return mod


def t32(a) -> torch.Tensor:
    return u32_to_torch(np.asarray(a).astype(np.uint32), CPU)


def k11_launch(x: np.ndarray, starts: np.ndarray, G: int, T: int, W: int, plan: k11.CopyPlan,
               sms: int, counter: np.ndarray, out: np.ndarray) -> tuple[list, dict]:
    """csrc/tile_copy.cu's launch under `plan` on `sms` SMs' worth of blocks:
    the entry zeroes the call's `counter` (``k11.COUNTER_BYTES``) and each
    block is a generator that yields between its steps.  The blocks take
    units from counter[0] and store into `out` (rows of W words).  Returns
    (the blocks, what they did: bulk copies, ring reloads, starts read,
    blocks whose units lay in more than one tile)."""
    rows = np.asarray(x).reshape(-1, W)
    n, S, R = len(rows), plan.unit_rows, plan.ring
    units, per_tile = n // S, T // S
    blocks = k11.copy_grid(n, plan, sms)
    stats = {"loads": 0, "stores": 0, "reloads": 0, "starts_read": 0, "multi_tile": 0,
             "blocks": blocks, "taken": 0}
    assert counter.dtype == np.int64 and counter.nbytes == k11.COUNTER_BYTES
    counter[:] = 0  # cudaMemsetAsync on the call's stream, before the launch

    def take_unit():  # atomicAdd(next_unit, 1)
        u = int(counter[0])
        counter[0] += 1
        stats["taken"] += 1
        return u

    def block():
        buf = [None] * R
        held = [-1] * R  # the unit a buffer holds
        dst = [0] * R
        phase = [0] * R  # completed phases of each buffer's barrier
        groups = []  # committed bulk groups not yet retired: (buffer, stores)
        last = {"t": -1, "start": 0, "loaded": 0}
        tiles = set()

        def retire(keep):  # cp.async.bulk.wait_group.read keep
            while len(groups) > keep:
                b, stores = groups.pop(0)
                for d, a, e in stores:
                    out[d: d + e - a] = buf[b][a: e]

        def load(u):
            b = last["loaded"] % R
            assert all(g[0] != b for g in groups), "a buffer reloaded under its stores"
            t = u // per_tile
            if t != last["t"]:
                last["t"], last["start"] = t, int(starts[t])
                stats["starts_read"] += 1
            tiles.add(t)
            buf[b] = rows[u * S: (u + 1) * S].copy()
            held[b], dst[b] = u, last["start"]
            phase[b] += 1
            last["loaded"] += 1
            stats["loads"] += 1

        yield
        nxt = take_unit()
        while last["loaded"] < R and nxt < units:
            load(nxt)
            yield
            nxt = take_unit()
        k = 0
        while k < last["loaded"]:
            b = k % R
            assert phase[b] == k // R + 1  # the wait on parity (k / R) & 1
            u = held[b]
            lo = (u % per_tile) * S
            stores = [(dst[b] + a, a - lo, e - lo) for a, e in k11.chunk_parts(lo, S, G)]
            stats["stores"] += len(stores)
            groups.append((b, stores))
            if k >= 1 and nxt < units:
                retire(1)
                load(nxt)
                stats["reloads"] += 1
                yield
                nxt = take_unit()
            k += 1
        retire(0)
        stats["multi_tile"] += len(tiles) > 1

    return [block() for _ in range(blocks)], stats


def run_interleaved(live: list, seed: int, stop_after=None) -> None:
    """Step the blocks (of one launch or several) in a random order from
    `seed` until all have ended, or `stop_after` steps (a launch that
    dies midway)."""
    order = np.random.default_rng(seed)
    steps = 0
    while live and (stop_after is None or steps < stop_after):
        i = int(order.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live.pop(i)
        steps += 1


def k11_emulate(x: np.ndarray, starts: np.ndarray, G: int, T: int, W: int, plan: k11.CopyPlan,
                sms: int, seed: int = 0,
                counter: np.ndarray | None = None) -> tuple[np.ndarray, dict]:
    """One launch of csrc/tile_copy.cu alone, its blocks' steps interleaved
    in a random order from `seed`, with the call's counter (a fresh one if
    None): the output rows and what the blocks did."""
    counter = np.zeros(k11.COUNTER_BYTES // 8, np.int64) if counter is None else counter
    out = np.zeros_like(np.asarray(x).reshape(-1, W))
    blocks, stats = k11_launch(x, starts, G, T, W, plan, sms, counter, out)
    run_interleaved(blocks, seed)
    n = out.shape[0]
    # every block's last take finds the units gone: one failed take a block
    assert counter[0] == n // plan.unit_rows + stats["blocks"]
    return out.reshape(np.asarray(x).shape), stats


@pytest.mark.parametrize("order", ["identity", "tile_permuted"])
@pytest.mark.parametrize("G", [32, 128, 2048])
def test_tile_copy_plain_matches_pallas(pallas_dma, G, order):
    import jax.numpy as jnp

    n, T = 8192, 2048
    g = np.random.default_rng(G)
    x = g.integers(0, 2**32, size=(n * 32 // 128, 128), dtype=np.uint64).astype(np.uint32)
    tiles = np.arange(n // T) if order == "identity" else g.permutation(n // T)
    starts = (tiles * T).astype(np.int32)
    want = np.asarray(pallas_dma.make_kernel(G, n, interpret=True)(
        jnp.asarray(x), jnp.asarray(starts)))
    got = tile_copy(t32(x), torch.from_numpy(starts), G)  # CPU: the plain version
    assert got.shape == x.shape
    np.testing.assert_array_equal(torch_to_u32(got), want)
    # the port's probe entry point computes the same copy
    np.testing.assert_array_equal(
        torch_to_u32(tdma.make_kernel(G, n)(t32(x), torch.from_numpy(starts))), want)
    if order == "tile_permuted":
        assert not np.array_equal(want, x)
    # the kernel as the card runs it, on 3 SMs' worth of blocks (ring
    # reloads, blocks whose units lie in several tiles) and on the H100's 132
    for sms in (3, k11.H100_SMS):
        emu, _ = k11_emulate(x, starts, G, T, 32, k11.copy_plan(T, 32), sms, seed=sms)
        np.testing.assert_array_equal(emu, want)


def plan_constants(monkeypatch, plan: str, W: int) -> None:
    """tile_copy's constants for `plan`, "S/R/blocks an SM" ("default":
    as they are), as tools/copy_sweep.py sets them."""
    if plan != "default":
        s, r, bps = map(int, plan.split("/"))
        monkeypatch.setattr(k11, "UNIT_BYTES", s * W * 4)
        monkeypatch.setattr(k11, "RING", r)
        monkeypatch.setattr(k11, "BLOCKS_PER_SM", bps)


@pytest.mark.parametrize("sms", [1, 3, 132])
@pytest.mark.parametrize("plan", ["default", "64/8/1", "512/2/1", "32/16/3", "256/4/2",
                                  "128/4/2", "64/8/4"])
@pytest.mark.parametrize("G", [32, 64, 128, 512, 2048])
def test_tile_copy_emulation_under_plans(monkeypatch, G, plan, sms):
    """The unit and ring plan at every G of the probe: units smaller and
    larger than a chunk (chunks that span units, split a store a unit),
    permuted starts, blocks that reload their ring and take units of
    several tiles in a random interleaving; the copies issued are the
    plan's count."""
    n, T, W = 16384, 2048, 32
    g = np.random.default_rng(G + sms)
    x = g.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    starts = (g.permutation(n // T) * T).astype(np.int32)
    plan_constants(monkeypatch, plan, W)
    p = k11.copy_plan(T, W)
    if plan != "default":
        s, r, bps = map(int, plan.split("/"))
        assert (p.unit_rows, p.ring) == (s, r)
        assert p.blocks_per_sm == min(bps, k11.resident_blocks(r * s * W * 4))
    emu, stats = k11_emulate(x, starts, G, T, W, p, sms, seed=G * sms)
    want = torch_to_u32(tile_copy_plain(t32(x), torch.from_numpy(starts), G, T, W))
    np.testing.assert_array_equal(emu, want)
    units = n // p.unit_rows
    assert stats["blocks"] == min(p.blocks_per_sm * sms, units)
    assert stats["loads"] == units and stats["taken"] == units + stats["blocks"]
    parts = sum(len(k11.chunk_parts(lo, p.unit_rows, G)) for lo in range(0, T, p.unit_rows))
    assert stats["stores"] == n // T * parts
    if G > p.unit_rows:
        assert parts == T // p.unit_rows  # a chunk spans units: one part a unit
    assert stats["loads"] + stats["stores"] == bulk_copies(n, G, T, W)
    assert stats["starts_read"] <= units
    if units > stats["blocks"] * p.ring:  # some block took more units than its ring holds
        assert stats["reloads"] > 0 and stats["multi_tile"] > 0


@pytest.mark.parametrize("W,T,G", [(8, 256, 64), (4, 64, 32), (512, 128, 32), (36, 2048, 32)])
def test_tile_copy_emulation_at_other_widths(W, T, G):
    """Other row widths and tiles: the unit is the largest multiple of 32
    rows dividing the tile within UNIT_BYTES, at least 32; the ring shrinks
    to fit shared memory, the blocks an SM to those resident together."""
    n = T * 9
    g = np.random.default_rng(W)
    x = g.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    starts = (g.permutation(n // T) * T).astype(np.int32)
    p = k11.copy_plan(T, W)
    assert p.unit_rows % 32 == 0 and T % p.unit_rows == 0
    assert p.unit_rows * W * 4 <= max(k11.UNIT_BYTES, 32 * W * 4)
    assert 2 <= p.ring <= k11.RING and p.ring * p.unit_rows * W * 4 <= k11.RING_BYTES
    ring_bytes = p.ring * p.unit_rows * W * 4
    assert 1 <= p.blocks_per_sm
    assert p.blocks_per_sm * (ring_bytes + k11.BLOCK_SHARED_BYTES) <= k11.SM_SHARED_BYTES
    emu, _ = k11_emulate(x, starts, G, T, W, p, 2, seed=W)
    want = torch_to_u32(tile_copy_plain(t32(x), torch.from_numpy(starts), G, T, W))
    np.testing.assert_array_equal(emu, want)


@pytest.mark.parametrize("plan", ["default", "64/8/1", "512/2/1"])
def test_tile_copy_emulation_two_streams_and_a_failed_launch(monkeypatch, plan):
    """Two calls at once, as on two streams, their blocks' steps
    interleaved, each with the counter its wrapper allocated: each equals
    the plain version.  A launch that stops midway leaves its counter past
    0; the next call that gets the same memory zeroes it in its own entry
    and copies every unit."""
    n, T, W, G = 16384, 2048, 32, 32
    g = np.random.default_rng(16)
    plan_constants(monkeypatch, plan, W)
    p = k11.copy_plan(T, W)
    calls, blocks = [], []
    for _ in range(2):
        x = g.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(np.uint32)
        starts = (g.permutation(n // T) * T).astype(np.int32)
        out = np.zeros_like(x)
        counter = np.full(k11.COUNTER_BYTES // 8, -12345, np.int64)  # torch.empty's bits
        b, stats = k11_launch(x, starts, G, T, W, p, 3, counter, out)
        calls.append((x, starts, out, counter, stats))
        blocks += b
    run_interleaved(blocks, seed=len(plan))
    for x, starts, out, counter, stats in calls:
        want = torch_to_u32(tile_copy_plain(t32(x), torch.from_numpy(starts), G, T, W))
        np.testing.assert_array_equal(out, want)
        assert counter[0] == n // p.unit_rows + stats["blocks"]
    x, starts = calls[0][:2]
    counter = np.zeros(k11.COUNTER_BYTES // 8, np.int64)
    dead, _ = k11_launch(x, starts, G, T, W, p, 3, counter, np.zeros_like(x))
    run_interleaved(dead, seed=3, stop_after=2 * len(dead) + 5)
    assert 0 < counter[0] < n // p.unit_rows
    emu, _ = k11_emulate(x, starts, G, T, W, p, 3, seed=4, counter=counter)
    np.testing.assert_array_equal(emu, calls[0][2])


def test_tile_copy_plan_refusals(monkeypatch):
    # the default: units of 64 rows, a ring of 6, the blocks that fit an SM,
    # and at the probe's shape every block takes more units than its ring holds
    p = k11.copy_plan(2048, 32)
    assert p == k11.CopyPlan(64, k11.RING, k11.resident_blocks(k11.RING * 64 * 128))
    assert (1 << 20) // p.unit_rows > k11.copy_grid(1 << 20, p) * p.ring
    assert k11.copy_grid(1 << 20, p) == p.blocks_per_sm * k11.H100_SMS
    assert k11.copy_grid(128, p, 132) == 2  # a block a unit at most
    assert k11.stage_rows(2048, 32) == 64 and k11.stage_rows(96, 1) == 96
    assert k11.resident_blocks(0) == k11.MAX_BLOCKS_PER_SM
    assert k11.resident_blocks(96 * 1024) == 2 and k11.resident_blocks(64 * 1024) == 3
    for values in ({"RING": 1}, {"RING": k11.MAX_RING + 1, "UNIT_BYTES": 32 * 128},
                   {"BLOCKS_PER_SM": 0}):
        with monkeypatch.context() as m:
            for k, v in values.items():
                m.setattr(k11, k, v)
            with pytest.raises(ValueError, match="tile_copy"):
                k11.copy_plan(2048, 32)
    with monkeypatch.context() as m:  # the ring shrinks to fit shared memory
        m.setattr(k11, "UNIT_BYTES", 64 * 1024)
        m.setattr(k11, "RING", 8)
        assert k11.copy_plan(2048, 32) == k11.CopyPlan(512, 3, 1)
    with pytest.raises(ValueError, match="tile_copy"):
        k11.copy_plan(4096, 2048)  # a 32-row unit of 8 KiB rows: no ring of 2 fits
    with pytest.raises(ValueError, match="tile_copy"):
        k11.stage_rows(48, 1)


@pytest.mark.parametrize("load", [True, False])
def test_row_move_plain_matches_pallas(permute_prims, load):
    import jax.numpy as jnp

    n, tile, w = permute_prims.N, permute_prims.T, permute_prims.W
    g = np.random.default_rng(int(load))
    x = g.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32)
    slot = np.concatenate([g.permutation(tile) for _ in range(n // tile)]).astype(np.int32)
    want = np.asarray(permute_prims.make_rowmove(load, interpret=True)(
        jnp.asarray(x), jnp.asarray(slot)))
    got = row_move(t32(x), torch.from_numpy(slot), tile, load)  # CPU: the plain version
    np.testing.assert_array_equal(torch_to_u32(got), want)
    np.testing.assert_array_equal(
        torch_to_u32(tprims.make_rowmove(load, tile)(t32(x), torch.from_numpy(slot))), want)


@pytest.mark.parametrize("load", [True, False])
@pytest.mark.parametrize("n", [0, 1, 31, 2049])
def test_row_move_global_form_matches_numpy(n, load):
    """One tile spanning all rows; slots outside [0, n) give a zero row
    (load) or move nothing (store)."""
    g = np.random.default_rng(n)
    x = g.integers(0, 2**32, size=(n, 5), dtype=np.uint64).astype(np.uint32)
    if load:
        slot = g.integers(-3, n + 3, size=n).astype(np.int32)
        ok = (slot >= 0) & (slot < n)
        want = np.where(ok[:, None], x[np.where(ok, slot, 0)], 0) if n else x
    else:
        slot = g.permutation(n).astype(np.int32)
        slot[g.random(n) < 0.2] = n + 1  # these rows land nowhere
        want = np.zeros_like(x)
        ok = slot < n
        want[slot[ok]] = x[ok]
    got = row_move(t32(x).reshape(n, 5), torch.from_numpy(slot), max(n, 1), load)
    np.testing.assert_array_equal(torch_to_u32(got).reshape(n, 5), want)
    # tiles smaller than the table: the same function per tile
    for tile in (1, 7):
        got_t = row_move_plain(t32(x).reshape(n, 5), torch.from_numpy(slot), tile, load)
        base = np.arange(n) - np.arange(n) % tile
        other = base + slot.astype(np.int64)
        ok = (slot >= 0) & (other < np.minimum(base + tile, n))
        want_t = np.zeros_like(x)
        if load:
            want_t[ok] = x[other[ok]]
        else:
            want_t[other[ok]] = x[ok]
        np.testing.assert_array_equal(torch_to_u32(got_t).reshape(n, 5), want_t)


def test_tile_copy_refuses_bad_arguments():
    x = torch.zeros((4096, 32), dtype=torch.int32)  # n = 4096 rows: 2 tiles of 2048
    ok = torch.tensor([2048, 0], dtype=torch.int32)
    assert torch.equal(tile_copy(x, ok, 64), tile_copy_plain(x, ok, 64))
    bad = [
        (torch.zeros((4000, 32), dtype=torch.int32), ok, 64),  # n % T != 0
        (x, ok, 96),  # G does not divide T
        (x, ok, 16),  # G % 32 != 0
        (x, torch.tensor([2048 + 16, 0], dtype=torch.int32), 64),  # a start off 32 rows
        (x, torch.tensor([2048, 2080], dtype=torch.int32), 64),  # starts[t] + T > n
        (x, torch.tensor([0, 0], dtype=torch.int32), 64),  # tiles overlap
        (x, torch.tensor([0], dtype=torch.int32), 64),  # one start for two tiles
    ]
    for args in bad:
        with pytest.raises(ValueError):
            tile_copy(*args)
    with pytest.raises(ValueError):
        row_move(x, torch.zeros(4096, dtype=torch.int32), 0, True)


def test_bulk_copies_counts_loads_and_chunk_parts():
    # the probe's shape: 512 tiles, 32 units of 64 rows a tile, a load a
    # unit and a store a chunk part of a unit
    n = 1 << 20
    assert {G: bulk_copies(n, G) for G in tdma.GS} == {
        32: 512 * 32 * (1 + 2), 64: 512 * 32 * (1 + 1), 128: 512 * 32 * (1 + 1),
        512: 512 * 32 * (1 + 1), 2048: 512 * 32 * (1 + 1)}


def test_probe_mains_check_on_the_cpu(capsys):
    assert tdma.main(["--cpu"]) == 0
    assert tprims.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    # K11 a G; P1 a shape, P2, P3 (the port's counterparts of the XLA measurements); P4, P5
    assert out.count("ok=True") == len(tdma.GS) + len(tprims.P1_SHAPES) + 4
    assert "ok=False" not in out and "not ported" not in out
