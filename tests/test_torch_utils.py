"""The port's utilities against the JAX package's, on the CPU.

``utils/roofline.py`` (the byte model, the audit and its report, the peak
table), ``utils/profiling.py`` (host timers that wait for the outputs, the
``torch.profiler`` trace and its named spans), ``metrics.batch_bytes`` and
the string helpers of ``batch.py``.  Every comparison with JAX is exact:
the same integers, the same floats from the same arithmetic, the same text.
"""

import dataclasses
import glob
import gzip
import json
import math

import jax
import numpy as np
import pytest
import torch

from database_technology_algorithms_tpu import batch as jbatch
from database_technology_algorithms_tpu import metrics as jmetrics
from database_technology_algorithms_tpu.utils import roofline as jroof
from database_technology_algorithms_tpu_torch import batch as tbatch
from database_technology_algorithms_tpu_torch import metrics as tmetrics
from database_technology_algorithms_tpu_torch import utils as tutils
from database_technology_algorithms_tpu_torch.utils import profiling as tprof
from database_technology_algorithms_tpu_torch.utils import roofline as troof

OPS = ("filter", "compact", "scan", "sort", "sort_batch", "distinct", "hash_join",
       "hash_join_count", "merge_join", "join_sorted_distinct", "aggregate", "group_aggregate",
       "shuffle", "all_to_all", "pipeline", "not_an_operator")


# ---------------------------------------------------------------------------
# roofline


@pytest.mark.parametrize("payload", [troof.ROW_BYTES_FULL, troof.ROW_BYTES_KEY, 24, None])
@pytest.mark.parametrize("op", OPS)
def test_min_bytes_matches_jax(op, payload):
    assert (troof.ROW_BYTES_FULL, troof.ROW_BYTES_KEY) == (jroof.ROW_BYTES_FULL,
                                                          jroof.ROW_BYTES_KEY)
    for rows in (0, 1, 1000, 10**6, 24 * 10**6):
        kw = {} if payload is None else {"payload_bytes": payload}
        got = troof.min_bytes(op, rows, **kw)
        assert got == jroof.min_bytes(op, rows, **kw)
        assert isinstance(got, int)


@pytest.mark.parametrize("wall_s", [0.0, 1e-6, 0.0137, 2.5])
@pytest.mark.parametrize("op", ["pipeline", "sort_batch", "hash_join_count", "not_an_operator"])
def test_audit_and_report_match_jax(op, wall_s):
    """The same peak (the nominal CPU entry on both sides): the same fields,
    line and report."""
    jax_cpu = jax.devices("cpu")[0]
    assert troof.chip_hbm_gbps(torch.device("cpu")) == jroof.chip_hbm_gbps(jax_cpu) == 50.0
    got = troof.audit(op, 1_000_000, wall_s, device="cpu")
    want = jroof.audit(op, 1_000_000, wall_s, device=jax_cpu)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.line() == want.line()
    other = troof.audit("sort", 4096, 0.5, payload_bytes=8, device="cpu")
    assert troof.report([got, other]) == jroof.report(
        [want, jroof.audit("sort", 4096, 0.5, payload_bytes=8, device=jax_cpu)])
    assert troof.report([]) == jroof.report([]) == "roofline (no results)"


def test_peaks_name_cards_and_never_guess(monkeypatch):
    """The H100's data-sheet figures; an unlisted card's name raises, where
    JAX falls back to 100 GB/s; no card and no device raises too."""
    assert troof.peak_for("NVIDIA H100 80GB HBM3", troof.HBM_GBPS) == 3350.0
    assert troof.peak_for("NVIDIA H100 80GB HBM3", troof.OPS_PER_S) == 67e12
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        troof.peak_for("NVIDIA A100-SXM4-80GB", troof.HBM_GBPS)
    monkeypatch.setattr(troof, "_card_name", lambda dev: "Tesla T4")
    with pytest.raises(ValueError, match="Tesla T4"):
        troof.chip_hbm_gbps(torch.device("cuda", 0))
    with pytest.raises(ValueError, match="Tesla T4"):
        troof.audit("sort", 10, 1.0, device=torch.device("cuda", 0))
    monkeypatch.setattr(troof, "_card_name", lambda dev: "NVIDIA H100 80GB HBM3")
    assert troof.chip_hbm_gbps(torch.device("cuda", 0)) == 3350.0
    assert troof.chip_ops_per_s(torch.device("cuda", 0)) == 67e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        troof.chip_hbm_gbps()
    assert not [k for k in troof.HBM_GBPS if "TPU" in k.upper()]


def test_utils_exports_what_jax_exports():
    from database_technology_algorithms_tpu import utils as jutils

    assert sorted(tutils.__all__) == sorted(jutils.__all__)
    assert tutils.audit is troof.audit and tutils.timed is tprof.timed


# ---------------------------------------------------------------------------
# profiling


def pipeline_like(n: int):
    """A few torch ops whose outputs nest a tuple, a dict and a batch."""
    x = torch.arange(n, dtype=torch.int32)
    b = tbatch.RecordBatch(recid=x, num=x * 3, strw=torch.zeros((n, 2), dtype=torch.int32),
                           valid=x % 2 == 0)
    return (x.sum(), {"batch": b, "list": [x.cumsum(0)]})


def test_timed_gives_best_time_and_output():
    seen = []

    def fn(n):
        seen.append(n)
        return pipeline_like(n)

    best, out = tprof.timed(fn, 1000, reps=4, warmup=2)
    assert len(seen) == 6
    assert 0 < best < 60 and math.isfinite(best)
    assert int(out[0]) == 1000 * 999 // 2
    assert isinstance(out[1]["batch"], tbatch.RecordBatch)


def test_fence_reads_the_first_tensor():
    out = pipeline_like(10)
    assert tprof.fence(out) == 45.0
    assert tprof.fence({"b": out[1]["batch"]}) == 0.0  # recid[0]
    assert tprof.fence([torch.tensor([True, False])]) == 1.0
    assert [t.shape for t in tprof._tensors(out)] == [
        (), (10,), (10,), (10, 2), (10,), (10,)]


def test_timed_steady_gives_per_call_and_first_call():
    calls = []

    def fn(n):
        calls.append(n)
        return pipeline_like(n)

    per, first = tprof.timed_steady(fn, (2000,), k=4, reps=3)
    assert len(calls) == 1 + 3 * (1 + 4)
    assert per > 0 and first > 0 and math.isfinite(per) and math.isfinite(first)


def test_trace_holds_the_annotated_span(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("stage_a"):
            pipeline_like(5000)
    files = glob.glob(str(tmp_path / "*.json*"))
    assert len(files) == 1
    opener = gzip.open if files[0].endswith(".gz") else open
    with opener(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "stage_a" in names
    assert "aten::cumsum" in names
    with tprof.trace(None):  # no trace, no file
        with tprof.annotate("stage_b"):
            pipeline_like(10)
    assert glob.glob(str(tmp_path / "*.json*")) == files


# ---------------------------------------------------------------------------
# metrics.batch_bytes and the string helpers


@pytest.mark.parametrize("with_strings", [True, False])
def test_batch_bytes_matches_jax(with_strings):
    for n in (0, 1, 100, 1 << 20, 24 * 10**6):
        assert tmetrics.batch_bytes(n, with_strings) == jmetrics.batch_bytes(n, with_strings)
    assert tmetrics.batch_bytes(7) == jmetrics.batch_bytes(7)


STRINGS = [b"", b"a", b"Hola", b"abcde", b"x" * 8, b"y" * 9, b"z" * 119, b"w" * 120,
           b"v" * 200, b"emb\0edded", bytes(range(1, 121))]


@pytest.mark.parametrize("strings", [STRINGS, [b"abc", b"abd"], [b"q" * 40] * 3],
                         ids=["edges", "short", "wide"])
def test_make_batch_from_strings_and_str_list_match_jax(strings):
    n = len(strings)
    recid = np.arange(n, dtype=np.uint32) + 0xFFFFFF00
    num = (np.arange(n, dtype=np.uint64) * 2654435761 % (1 << 32)).astype(np.uint32)
    got = tbatch.make_batch_from_strings(recid, num, strings, device="cpu")
    want = jbatch.make_batch_from_strings(recid, num, strings)
    assert got.str_words == want.str_words
    for name in ("recid", "num", "strw"):
        np.testing.assert_array_equal(tbatch.torch_to_u32(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.str_list() == want.str_list()
    assert got.str_list()[:1] == [strings[0][:120].split(b"\0")[0]]


def test_make_batch_from_strings_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tbatch.make_batch_from_strings([1], [2], [b"abc"])
