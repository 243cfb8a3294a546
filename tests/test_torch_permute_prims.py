"""P1-P3 of the permute probe (``tools/bench_permute_prims.py``) on the CPU.

The repository's probe times XLA operations: a replicated-key 2-D
``lax.sort`` (P1) and one-hot ``dot_general`` permutes in bf16 and int8
(P2, P3).  The port's counterparts (``sort2d``, ``onehot_permute``) are
held here at tiny shapes against ``jax.lax.sort`` and ``jax.lax.dot_general``
applied, as the repository's probe applies them, to the same numpy inputs.
Every value is an integer, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu_torch.tools import bench_permute_prims as prims
from database_technology_algorithms_tpu_torch.utils import roofline


@pytest.mark.parametrize("keys", ["permutation", "ties"])
@pytest.mark.parametrize("g,npay", prims.P1_SHAPES)
def test_sort2d_matches_lax_sort(g, npay, keys):
    n = 3000
    key, pays = prims.p1_inputs(n, g, npay, seed=g * 10 + npay)
    if keys == "ties":  # few key values: the stable order decides
        key = np.ascontiguousarray(key % 7)
    got = prims.sort2d(torch.from_numpy(key), *(torch.from_numpy(p) for p in pays))
    want = jax.lax.sort((jnp.asarray(key.astype(np.uint32)),)
                        + tuple(jnp.asarray(p.astype(np.uint32)) for p in pays),
                        num_keys=1, dimension=0)[1:]
    assert len(got) == npay
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a.numpy().astype(np.uint32), np.asarray(b))


def jax_onehot_permute(x: np.ndarray, slot: np.ndarray, s: int, int8: bool) -> np.ndarray:
    """The repository probe's P2/P3 computation on the same inputs."""
    oh = jnp.asarray(slot)[:, None, :] == jax.lax.broadcasted_iota(jnp.int32, (1, s, 1), 1)
    dims = (((2,), (1,)), ((0,), (0,)))
    if int8:
        y = jax.lax.dot_general(oh.astype(jnp.int8), jnp.asarray(x).astype(jnp.int8), dims,
                                preferred_element_type=jnp.int32)
        return np.asarray((y & 0xFF).astype(jnp.uint8))
    y = jax.lax.dot_general(oh.astype(jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16), dims,
                            preferred_element_type=jnp.float32)
    return np.asarray(y.astype(jnp.uint8))


@pytest.mark.parametrize("tb,tile", [(2, 64), (3, 128)])
@pytest.mark.parametrize("int8", [False, True], ids=["P2 bf16", "P3 int8"])
def test_onehot_permute_matches_dot_general(int8, tb, tile):
    x, slot = prims.p23_inputs(tb, tile, seed=tile + tb)
    got = prims.onehot_permute(torch.from_numpy(x), torch.from_numpy(slot), 2 * tile, int8)
    want = jax_onehot_permute(x, slot, 2 * tile, int8)
    assert got.dtype == torch.uint8 and got.shape == (tb, 2 * tile, prims.C4)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.zeros_like(want)  # the permutation itself: the slotted rows, zero elsewhere
    for b in range(tb):
        ref[b, slot[b]] = x[b]
    np.testing.assert_array_equal(got.numpy(), ref)


def test_tensor_peaks_name_the_card(monkeypatch):
    monkeypatch.setattr(roofline, "_card_name", lambda dev: "NVIDIA H100 80GB HBM3")
    cuda = torch.device("cuda", 0)
    assert roofline.chip_tensor_ops_per_s("bf16", cuda) == 989e12
    assert roofline.chip_tensor_ops_per_s("int8", cuda) == 1979e12
    monkeypatch.setattr(roofline, "_card_name", lambda dev: "some other card")
    with pytest.raises(ValueError, match="no peak is on record"):
        roofline.chip_tensor_ops_per_s("bf16", cuda)
