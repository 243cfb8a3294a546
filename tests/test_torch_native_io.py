"""The port's native block-file IO (``io/native.py`` over the unchanged
``native/dbtio.cpp``) against its numpy codec and against the JAX
package's ``io/native.py``, on the same files: equal columns."""

import numpy as np
import pytest

from database_technology_algorithms_tpu.io import native as jnative
from database_technology_algorithms_tpu_torch.batch import MAX_RECORDS_PER_BLOCK
from database_technology_algorithms_tpu_torch.io import blockfile as tbf
from database_technology_algorithms_tpu_torch.io import native as tnative
from database_technology_algorithms_tpu_torch.io.generator import generate_columns


def same_cols(a: dict, b: dict) -> None:
    assert set(a) == set(b) == {"recid", "num", "strs", "valid"}
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_library_builds_apart_from_the_jax_one():
    assert tnative.get_lib() is not None
    assert tnative.LIB_PATH.name == "libdbtio.so"
    assert tnative.LIB_PATH.parent.name == "torch_native"
    assert tnative.LIB_PATH != jnative._LIB_PATH


@pytest.mark.parametrize("nrows", [0, 1, 100, 842])
def test_native_read_matches_numpy_and_jax(nrows, tmp_path):
    """A partial final block, an exact block, one row and an empty file."""
    cols = generate_columns(9, seed=5)
    cols = {k: v[:nrows] for k, v in cols.items()}
    path = str(tmp_path / "x.bin")
    tbf.write_blockfile(path, cols)
    got = tnative.read_blockfile_native(path)
    same_cols(got, tbf.read_blockfile_numpy(path))
    same_cols(got, jnative.read_blockfile_native(path))
    assert tnative.count_rows_native(path) == nrows


def test_native_read_normalizes_and_honours_headers(tmp_path):
    """Bytes after a string's NUL are zeroed and a block's ``nreserved``
    bounds its rows, in both codecs."""
    cols = generate_columns(3, seed=8)
    path = str(tmp_path / "raw.bin")
    tbf.write_blockfile(path, cols)
    blocks = np.fromfile(path, dtype=tbf.BLOCK_DTYPE)
    blocks["entries"]["str"][:, :, 7] = ord("x")  # after the 5-letter string's NUL
    blocks["entries"]["valid"][1, ::3] = 0
    blocks["nreserved"][1] = 37
    blocks.tofile(path)
    got = tnative.read_blockfile_native(path)
    same_cols(got, tbf.read_blockfile_numpy(path))
    assert len(got["recid"]) == 2 * MAX_RECORDS_PER_BLOCK + 37
    assert not got["strs"][:, 5:].any() and not got["valid"].all()


@pytest.mark.parametrize("nthreads", [1, 2, 3, 7])
def test_native_read_by_thread_count_matches_numpy_and_jax(nthreads, tmp_path):
    """The reader splits the blocks among its threads: any split, also one
    that leaves threads without a whole share, gives the same columns."""
    cols = generate_columns(11, seed=4)
    cols = {k: v[:1037] for k, v in cols.items()}
    path = str(tmp_path / "t.bin")
    tbf.write_blockfile(path, cols)
    got = tnative.read_blockfile_native(path, nthreads=nthreads)
    same_cols(got, tbf.read_blockfile_numpy(path))
    same_cols(got, jnative.read_blockfile_native(path, nthreads=nthreads))


@pytest.mark.parametrize("native_builds", [True, False])
def test_read_blockfile_routes_give_the_same_batch(native_builds, tmp_path, monkeypatch):
    """``read_blockfile`` reads through the library, and through the numpy
    codec where the library gives None (no compiler)."""
    cols = generate_columns(2, seed=9)
    path = str(tmp_path / "r.bin")
    tbf.write_blockfile(path, cols)
    reads = []
    real = tnative.read_blockfile_native
    monkeypatch.setattr(tnative, "read_blockfile_native",
                        lambda p: reads.append(p) or (real(p) if native_builds else None))
    batch = tbf.read_blockfile(path, device="cpu")
    assert reads == [path]
    same_cols(batch.to_numpy(), tbf.read_blockfile_numpy(path))


def test_missing_file_gives_none(tmp_path):
    assert tnative.read_blockfile_native(str(tmp_path / "absent.bin")) is None
    assert tnative.count_rows_native(str(tmp_path / "absent.bin")) is None


# ---------------------------------------------------------------------------
# the writer and the pair generator


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("nrows", [1, 100, 842])
def test_native_write_roundtrip_and_bytes(nrows, tmp_path):
    """A partial final block, an exact block and one row: the columns read
    back, and the bytes of the numpy writer and of the JAX binding."""
    cols = generate_columns(9, seed=6)
    cols = {k: v[:nrows] for k, v in cols.items()}
    cols["valid"][::5] = False
    paths = [str(tmp_path / f"{name}.bin") for name in ("native", "numpy", "jax")]
    assert tnative.write_blockfile_native(paths[0], cols) == -(-nrows // MAX_RECORDS_PER_BLOCK)
    tbf.write_blockfile(paths[1], cols)
    jnative.write_blockfile_native(paths[2], cols)
    same_cols(tbf.read_blockfile_numpy(paths[0]), cols)
    assert read_bytes(paths[0]) == read_bytes(paths[1]) == read_bytes(paths[2])


def test_native_write_pads_narrow_strings(tmp_path):
    """Strings narrower than 128 bytes are zero-padded, and `valid` is all
    true where it is not given, as in the JAX binding."""
    cols = generate_columns(2, seed=3)
    narrow = {"recid": cols["recid"], "num": cols["num"], "strs": cols["strs"][:, :8]}
    assert not cols["strs"][:, 8:].any()  # 5-letter strings
    a, b, c = (str(tmp_path / f"{n}.bin") for n in "abc")
    assert tnative.write_blockfile_native(a, narrow) == 2
    jnative.write_blockfile_native(b, narrow)
    tbf.write_blockfile(c, dict(cols, valid=np.ones(len(cols["recid"]), bool)))
    assert read_bytes(a) == read_bytes(b) == read_bytes(c)
    back = tbf.read_blockfile_numpy(a)
    assert back["valid"].all() and back["strs"].shape[1] == 128
    np.testing.assert_array_equal(back["strs"], cols["strs"])


@pytest.mark.parametrize("seed,key_range", [(3, 300), (11, 1), (7, 3 * 10**6)])
def test_generate_pair_native_matches_jax(seed, key_range, tmp_path):
    """Both files byte for byte the JAX binding's for the same blocks, seed
    and key range: 1000 rows a file, every num below the key range."""
    mine = [str(tmp_path / f"t{i}.bin") for i in (1, 2)]
    theirs = [str(tmp_path / f"j{i}.bin") for i in (1, 2)]
    assert tnative.generate_pair_native(*mine, 10, seed, key_range) == 1000
    assert jnative.generate_pair_native(*theirs, 10, seed, key_range) == 1000
    for a, b in zip(mine, theirs):
        assert read_bytes(a) == read_bytes(b)
        cols = tnative.read_blockfile_native(a)
        assert len(cols["recid"]) == 1000
        assert (cols["num"] < key_range).all()
        np.testing.assert_array_equal(cols["recid"], np.arange(1000, dtype=np.uint32))


def test_writer_and_generator_give_none_where_the_library_fails(tmp_path):
    """A path that cannot be opened gives None, as does a missing library."""
    cols = generate_columns(1, seed=1)
    bad = str(tmp_path / "no_dir" / "x.bin")
    assert tnative.write_blockfile_native(bad, cols) is None
    assert tnative.generate_pair_native(bad, bad, 1, 0, 10) is None
