"""The port's distributed plan against the JAX package's, bit for bit, with
the exchanges in two slices (``cfg.shuffle_nchunks = 2``; the overlap engine
then probes in two slices too), and on BASELINE config 4's Zipf-keyed
tables under each engine.  The cases and comparisons are those of
``test_torch_dist_pipeline.py``; a file of their own lets the test runner
spread the JAX compiles over two workers.
"""

import pytest

from test_torch_dist_pipeline import (
    COUNTERS, ENGINES, cases, check_case, run_both, same_run, single_counters)


@pytest.mark.parametrize("kind,field,engine,nchunks", cases(2))
def test_dist_pipeline_chunked_matches_jax(kind, field, engine, nchunks):
    check_case(kind, field, engine, nchunks)


@pytest.mark.parametrize("engine", ENGINES)
def test_dist_pipeline_zipf_matches_jax(engine):
    """BASELINE config 4's keys: a few keys hold most rows; local-first dedup
    sends at most one row a key a shard, and the skew engine finds the hot
    keys among the dedup'd sides."""
    r, s, got, want = run_both(4, 1, engine, 1, "zipf")
    same_run(got, want)
    assert {k: int(got[k]) for k in COUNTERS} == single_counters(r, s, 1)
