"""The plain versions of K11 (tile copy) and K12 (row move) against the
repository's two Pallas kernels, run in interpret mode on the CPU.

The Pallas kernels live in probe scripts (``tools/bench_pallas_dma.py``
``make_kernel``, ``tools/bench_permute_prims.py`` ``make_rowmove``), loaded
here by file path; the module globals the row move reads (N, T) are set on
the loaded module.  Inputs are made from a seed with numpy; every value is a
u32 word, so every comparison is exact (tolerance: max abs err 0).  The
global form of K12 (one tile spanning all rows, the placement route's
gather) and the argument checks of K11 are held against numpy.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu_torch.batch import torch_to_u32, u32_to_torch
from database_technology_algorithms_tpu_torch.kernels.row_move import row_move, row_move_plain
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
    # the probe's shape: 512 tiles, two stages of 1024 rows a tile
    n = 1 << 20
    assert {G: bulk_copies(n, G) for G in tdma.GS} == {
        32: 512 * 2 * (1 + 32), 64: 512 * 2 * (1 + 16), 128: 512 * 2 * (1 + 8),
        512: 512 * 2 * (1 + 2), 2048: 512 * 2 * (1 + 1)}


def test_probe_mains_check_on_the_cpu(capsys):
    assert tdma.main(["--cpu"]) == 0
    assert tprims.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("ok=True") == len(tdma.GS) + 2 and "ok=False" not in out
    assert "P1: an XLA primitive measurement" in out
