"""The PyTorch port's invariant guards (``utils/checks.py``) against the JAX
package's, the counterparts of ``tests/test_checks.py:19-54``, and the
CLI's ``pipeline --debug-checks`` against the JAX CLI.

The port stores u32 words as int32 bit patterns, so its dtype check expects
int32 where JAX's expects uint32; every other message is JAX's own.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import model as M
from database_technology_algorithms_tpu.__main__ import main as j_main
from database_technology_algorithms_tpu.batch import RecordBatch as JBatch
from database_technology_algorithms_tpu.utils import checks as jchecks
from database_technology_algorithms_tpu_torch.__main__ import main as t_main
from database_technology_algorithms_tpu_torch.batch import RecordBatch as TBatch
from database_technology_algorithms_tpu_torch.batch import pack_str_bytes, u32_to_torch
from database_technology_algorithms_tpu_torch.utils.checks import (
    assert_batch, check_batch, checked_take)

CPU = torch.device("cpu")


def port_batch(cols: dict) -> TBatch:
    return TBatch.from_numpy(cols["recid"], cols["num"], cols["strs"], cols["valid"],
                             device="cpu")


def test_healthy_batch_passes():
    b = port_batch(M.random_cols(np.random.default_rng(1), 64))
    assert check_batch(b, count=10) == []
    assert_batch(b, count=64)
    assert_batch(b, count=torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("count", [-1, 17])
def test_bad_count_flagged_as_jax_flags_it(count):
    cols = M.random_cols(np.random.default_rng(2), 16)
    got = check_batch(port_batch(cols), count=count)
    want = jchecks.check_batch(M.to_batch(cols), count=count)
    assert got == want and any("live count" in p for p in got)
    with pytest.raises(AssertionError, match="live count"):
        assert_batch(port_batch(cols), count=count)


def test_nul_normalization_violation_flagged():
    """A byte after a NUL, written with the port's own packing (big-endian
    words, as pack_str_bytes lays them), is found; JAX finds the same rows
    in the same words."""
    cols = M.random_cols(np.random.default_rng(3), 8)
    strs = np.zeros((8, 8), np.uint8)
    strs[:, :3] = 0x61
    strs[0, :] = 0
    strs[0, 6] = 0x41  # after the NUL at byte 0
    strs[5, 4] = 0
    strs[5, 7] = 0x42  # a NUL, then a byte, in the second word
    words = pack_str_bytes(strs)
    bad = TBatch(recid=u32_to_torch(cols["recid"], CPU), num=u32_to_torch(cols["num"], CPU),
                 strw=u32_to_torch(words, CPU), valid=torch.ones(8, dtype=torch.bool))
    got = check_batch(bad)
    assert got == ["2 rows have bytes after the first NUL"]
    jbad = JBatch(recid=jnp.asarray(cols["recid"]), num=jnp.asarray(cols["num"]),
                  strw=jnp.asarray(words), valid=jnp.ones(8, bool))
    assert jchecks.check_batch(jbad) == got
    with pytest.raises(AssertionError, match="NUL"):
        assert_batch(bad)
    # normalized at ingestion, the same bytes are healthy
    assert check_batch(TBatch.from_numpy(cols["recid"], cols["num"], strs, device="cpu")) == []


def test_shape_and_dtype_flagged():
    b = port_batch(M.random_cols(np.random.default_rng(4), 6))
    wide = TBatch(recid=b.recid, num=b.num.long(), strw=torch.zeros((6, 3), dtype=torch.int32),
                  valid=b.valid.to(torch.int32))
    problems = check_batch(wide)
    assert any(p.startswith("strw shape (6, 3) != (6, K)") for p in problems)
    assert "num dtype torch.int64 != torch.int32" in problems
    assert "valid dtype torch.int32 != bool" in problems
    short = TBatch(recid=b.recid, num=b.num[:5], strw=b.strw, valid=b.valid[:4])
    problems = check_batch(short)
    assert "num shape (5,) != (6,)" in problems and "valid shape (4,) != (6,)" in problems


def test_checked_take_raises_past_upper():
    col = torch.arange(10, dtype=torch.int32)
    out = checked_take(col, torch.tensor([0, 5, 9], dtype=torch.int32), upper=9)
    assert out.tolist() == [0, 5, 9]
    with pytest.raises(IndexError, match="max 12 > 9"):
        checked_take(col, torch.tensor([0, 5, 12], dtype=torch.int32), upper=9)
    with pytest.raises(IndexError, match="min -1 < 0"):
        checked_take(col, torch.tensor([-1, 3], dtype=torch.int32), upper=9)
    # at `upper` past the column's rows: no error, the index is clipped as
    # jnp.take(mode="clip") clips it
    assert checked_take(col[:4], torch.tensor([4, 1], dtype=torch.int32), upper=4).tolist() == [3, 1]


def test_debug_checks_cli_matches_jax(tmp_path, monkeypatch, capsys):
    argv = ["pipeline", "--nblocks", "3", "--field", "1", "--skip-files", "--debug-checks"]
    monkeypatch.setattr(sys, "argv", ["database_technology_algorithms_tpu", *argv,
                                      "--workdir", str(tmp_path)])
    assert j_main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_main([*argv, "--workdir", str(tmp_path), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["joins_agree"] is True


def test_debug_checks_cli_runs_the_checks(tmp_path, monkeypatch, capsys):
    """The flag reaches assert_batch on both tables, once each."""
    from database_technology_algorithms_tpu_torch.utils import checks

    seen = []
    monkeypatch.setattr(checks, "assert_batch", lambda b, count=None: seen.append(b.nrows))
    argv = ["pipeline", "--nblocks", "2", "--skip-files", "--device", "cpu"]
    assert t_main([*argv, "--workdir", str(tmp_path)]) == 0
    assert seen == []
    assert t_main([*argv, "--workdir", str(tmp_path), "--debug-checks"]) == 0
    assert seen == [200, 200]
