"""Hash join (build-side key set, streamed probe; semi-join semantics).

Port of the in-budget generic engine of the JAX package's
``ops/hash_join.py``.  Reference semantics (``DatabaseProject.cpp:504-647``):
the build phase collapses file1 to a key set for fields 0-2 and keeps every
(num, str) pair for field 3; the probe phase streams file2 and emits the
probe-side record on a hit, once for fields 0-2 and once per matching build
record for field 3.  ``nres`` is the sum of per-probe-row multiplicities.

Engine form: one sort of build||probe by (inactive, key, row) puts each
key's build rows before its probe rows; a prefix count of active build rows
with one forward and one reversed run carry (K2) gives every row its run's
build total; one un-permute (K7) returns the probe rows' answers to probe
order.  No record moves until the matched probe rows are compacted.
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import FIELD_NUMSTR, RecordBatch, canonical_field
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.unpermute import unpermute
from ..utils.checks import ensure_device_budget
from .movement import compact_rows
from .scan import cumsum, seg_carry
from .sort import packed_u32_view_sort, sort_keys, sorted_adjacent_equal


def _fused_matched_mult(
    build: RecordBatch,
    probe: RecordBatch,
    field: int,
    cfg: EngineConfig,
    build_count,
    probe_count,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(matched bool[P], build multiplicity int32[P]) from one sort.

    For the u32 fields under ``cfg.packed_u32_sorts`` the multiplicity is
    not carried back (the caller reads only `matched`) and the second
    result is ``matched`` as int32, as in the JAX package.
    """
    nb, npr = build.nrows, probe.nrows
    both = RecordBatch.concat([build, probe])
    n = nb + npr
    if n == 0:
        return both.valid, both.recid
    idx = torch.arange(n, dtype=torch.int32, device=both.recid.device)
    b_active = idx < nb if build_count is None else (idx < nb) & (idx < build_count)
    p_active = idx >= nb if probe_count is None else (idx >= nb) & ((idx - nb) < probe_count)
    active = b_active | p_active
    packed = field in (0, 1) and cfg.packed_u32_sorts
    if packed:
        key = both.recid if field == 0 else both.num
        s_key, perm, active_s, _ = packed_u32_view_sort(~active, key)
        adj = sorted_adjacent_equal(s_key)
    else:
        view = sort_keys(both, field, cfg, pre_words=(~active,),
                         extra=(active.to(torch.int32),))
        active_s = view.extras[0] == 1
        perm, adj = view.perm, view.adj_eq
    s_build = perm < nb
    is_start = ~adj
    end_flags = torch.cat([is_start[1:], is_start.new_ones(1)])

    ab = (active_s & s_build).to(torch.int32)
    cb = cumsum(ab)  # inclusive active-build count
    # run's build total = (inclusive cb at run end) - (exclusive cb at start)
    start_excl = seg_carry(is_start, cb - ab)
    end_incl = seg_carry(end_flags, cb, reverse=True)
    mult_sorted = torch.where(active_s & ~s_build, end_incl - start_excl, 0)

    # answers back to probe order: probe row j sits where perm == nb + j
    if packed:
        matched = unpermute(perm, mult_sorted > 0, lo=nb, m=npr)
        return matched, matched.to(torch.int32)
    mult = unpermute(perm, mult_sorted, lo=nb, m=npr)
    return mult > 0, mult


def hash_join_count_impl(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    build_count=None,
    probe_count=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (matched bool[P], mult int32[P], nres int32).

    nres reproduces the reference counter: fields 0-2 count each matched
    probe row once; field 3 counts build-side duplicates per probe row.
    build_count/probe_count mark live rows under the static-capacity
    convention (padding rows never build nor match).
    """
    field = canonical_field(field)
    ensure_device_budget(build.nrows + probe.nrows, cfg, "hash_join_count")
    if cfg.u32_join_engine != "generic":
        raise NotImplementedError(
            f"u32_join_engine={cfg.u32_join_engine!r}: the alternative join "
            "engines are not ported yet (ROADMAP.md, Queue 1 item 12)"
        )
    matched, mult = _fused_matched_mult(build, probe, field, cfg, build_count, probe_count)
    if field != FIELD_NUMSTR:
        mult = matched.to(torch.int32)
    return matched, mult, mult.sum(dtype=torch.int32)


# The JAX package's public forms route over-budget pairs through a tiled
# join with a capacity-doubling retry; that route is not ported, so the
# public names are the in-budget functions, whose budget gate raises.
hash_join_count = hash_join_count_impl


def hash_join_impl(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor]:
    """Semi-join emitting matched probe rows, in probe order.

    Returns (probe-capacity batch, nres).  For field 3 the emitted rows are
    the matched probe rows, once each, while nres counts build duplicates;
    ``hash_join_count`` with ``materialize_field3`` gives the reference's
    row-repetition output.
    """
    ensure_device_budget(probe.nrows, cfg, "hash_join[materializing]")
    matched, _, nres = hash_join_count_impl(build, probe, field, cfg)
    out, _, _ = compact_rows(probe, matched, cfg=cfg)
    return out, nres


hash_join = hash_join_impl


def materialize_field3(probe: RecordBatch, matched, mult) -> RecordBatch:
    """Emit probe row j ``mult[j]`` times, on the host (``np.repeat``): the
    reference's field-3 multimap output (``DatabaseProject.cpp:619-628``),
    used at IO boundaries where the total is known.  The batch is made on
    the probe's device."""
    reps = np.asarray(mult.cpu() if isinstance(mult, torch.Tensor) else mult)
    cols = probe.to_numpy()
    return RecordBatch.from_numpy(
        np.repeat(cols["recid"], reps),
        np.repeat(cols["num"], reps),
        np.repeat(cols["strs"], reps, axis=0),
        np.repeat(cols["valid"], reps),
        normalize=False,
        device=probe.recid.device,
    )
