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

Beyond ``cfg.mem_rows`` the public forms route through the device-tiled
join: both sides are hashed (K8) and staged into cells (K9), the cell pairs
are joined a budget-sized group at a time (K10, whose counts land compacted
in slot order), and the counts return to probe order through one gather by
each probe row's slot (K7's gather form).

For fields 0 and 1, ``cfg.u32_join_engine`` picks one of the single-word
key engines instead of the generic one, as in the JAX package:
"searchsorted" (``ops/fastpath.py``, K15), "table" (``ops/hash_table.py``,
K16 and K17) and "bucketed" (``ops/bucket_join.py``, K18), whose fallback
is ``build_key_multiset`` + ``probe_multiplicity`` here.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..batch import FIELD_NUMSTR, RecordBatch, canonical_field
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels import cells_plan
from ..kernels.compact import compact_words
from ..kernels.expand_sources import expand_sources
from ..kernels.member_mult import member_multiplicity_cells
from ..kernels.unpermute import unpermute, unpermute_gather
from ..utils.checks import ensure_device_budget
from .keys import key_hash, key_words
from .movement import compact_rows, stage_to_cells
from .scan import cumsum, seg_carry
from .sort import materialize_survivors, packed_u32_view_sort, sort_keys, sorted_adjacent_equal


log = logging.getLogger(__name__)

def build_key_multiset(
    build: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    count=None,
) -> tuple[RecordBatch, torch.Tensor, torch.Tensor]:
    """Collapse the build side to (unique-key rows, per-key count, n_unique).

    The heir of the reference's hash-table build phase
    (``DatabaseProject.cpp:518-547``): the map's key set plus, for field 3,
    the multimap's per-key multiplicity.  One key sort, the survivors
    materialized (``materialize_survivors``), and the per-key counts as
    differences of the inclusive active count (K2) at the run ends,
    compacted (K3)."""
    n = build.nrows
    pre, extra = (), ()
    if count is not None:
        act0 = torch.arange(n, dtype=torch.int32, device=build.recid.device) < count
        pre, extra = (~act0,), (act0.to(torch.int32),)
    view = sort_keys(build, field, cfg, pre_words=pre, extra=extra, pre_is_mask=True)
    active = view.extras[0] == 1 if count is not None else torch.ones_like(view.adj_eq)
    adj = view.adj_eq
    new_run = active & ~adj
    # run end: active and (last row, or next row inactive, or next key differs)
    nxt_active = torch.cat([active[1:], active.new_zeros(1)])
    nxt_same = torch.cat([adj[1:], adj.new_zeros(1)])
    is_end = active & (~nxt_active | ~nxt_same)
    c_incl = cumsum(active.to(torch.int32))
    uniq, n_unique = materialize_survivors(build, view.perm, new_run, cfg)
    _, (ends,) = compact_words(is_end, (c_incl,))
    prev = torch.cat([ends.new_zeros(1), ends[:-1]])
    rows = torch.arange(n, dtype=torch.int32, device=ends.device)
    return uniq, torch.where(rows < n_unique, ends - prev, 0), n_unique


def probe_multiplicity(
    build_uniq: RecordBatch,
    build_counts: torch.Tensor,
    n_build,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    probe_count=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-probe-row (matched, build multiplicity), in probe original order.

    Sort build||probe by (inactive, key, row): each equal-key run holds at
    most one build row, first (build rows occupy [0, nb)).  A segmented
    carry (K2) hands every row its run head's (is-build, multiplicity), and
    one un-permute (K7) returns the probe rows' answers to probe order."""
    nb, np_ = build_uniq.nrows, probe.nrows
    both = RecordBatch.concat([build_uniq, probe])
    n = nb + np_
    idx = torch.arange(n, dtype=torch.int32, device=both.recid.device)
    probe_active = idx >= nb if probe_count is None else (idx - nb) < probe_count
    active = torch.where(idx < nb, idx < n_build, probe_active)
    counts_w = torch.cat([build_counts.to(torch.int32), idx.new_zeros(np_)])
    view = sort_keys(both, field, cfg, pre_words=(~active,),
                     extra=(active.to(torch.int32), counts_w), pre_is_mask=True)
    s_act, s_cnt = view.extras
    s_build = view.perm < nb
    is_start = ~view.adj_eq  # element 0 always True
    # head info packed: bit 31 = head is an active build row; low bits = count
    head_is_build = is_start & s_build & (s_act == 1)
    low = torch.where(s_cnt < 0, 0x7FFFFFFF, s_cnt)  # min(count, 0x7FFFFFFF) unsigned
    carry = seg_carry(is_start, torch.where(head_is_build, low | -(1 << 31), low))
    matched_sorted = ~s_build & (s_act == 1) & (carry < 0)
    mult_sorted = torch.where(matched_sorted, carry & 0x7FFFFFFF, 0)
    matched = unpermute(view.perm, matched_sorted, lo=nb, m=np_)
    mult = unpermute(view.perm, mult_sorted, lo=nb, m=np_)
    return matched, mult


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
    if field in (0, 1) and cfg.u32_join_engine != "generic":
        # single-word key engines, for fields 0 and 1 only as in the JAX
        # package; all of them return the generic engine's result
        if cfg.u32_join_engine == "searchsorted":
            from .fastpath import hash_join_count_u32

            return hash_join_count_u32(build, probe, field,
                                       build_count=build_count, probe_count=probe_count)
        if cfg.u32_join_engine == "table":
            from .hash_table import hash_join_count_table

            return hash_join_count_table(build, probe, field, cfg,
                                         build_count=build_count, probe_count=probe_count)
        if cfg.u32_join_engine == "bucketed":
            from .bucket_join import hash_join_count_bucketed

            return hash_join_count_bucketed(build, probe, field, cfg,
                                            build_count=build_count, probe_count=probe_count)
        raise ValueError(f"unknown u32_join_engine {cfg.u32_join_engine!r}")
    matched, mult = _fused_matched_mult(build, probe, field, cfg, build_count, probe_count)
    if field != FIELD_NUMSTR:
        mult = matched.to(torch.int32)
    return matched, mult, mult.sum(dtype=torch.int32)


def member_multiplicity(bwords: list, n_bkeys, kwords: list, live_k: torch.Tensor) -> torch.Tensor:
    """Per query key, the number of live build rows with the same key: one
    cell pair of kernel K10.  `bwords` are the build key's words (live rows
    first, `n_bkeys` of them; the port needs no order among them), `kwords`
    the query keys in any order with the mask `live_k`.  Returns int32 counts
    in query order, 0 for no match or a dead query row; fields 0-2 read them
    as a boolean, field 3 sums them."""
    dev = bwords[0].device
    nb = torch.as_tensor(n_bkeys, dtype=torch.int32, device=dev).reshape(1)
    out = member_multiplicity_cells(
        [w.contiguous()[None, :] for w in bwords], nb,
        [w.contiguous()[None, :] for w in kwords], None, live_k.contiguous()[None, :],
    )
    return out[0]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _tile_layout(nb: int, npr: int, mem_rows: int, cap_mult: int = 1) -> tuple[int, int, int, int]:
    """(ntiles, cap_b, cap_p, group) for the tiled over-budget join: the one
    definition of the tiling geometry, copied from the JAX package
    (``ops/hash_join.py:355``).  Tiles are sized so that a group of cell pairs
    fits the row budget and a pair holds at most about 16384 rows a side;
    cell capacity carries 1.5x slack over a uniform hash split, times
    `cap_mult`."""
    mem = max(int(mem_rows), 2)
    ntiles = max(
        _next_pow2(-(-(2 * (nb + npr)) // mem)),
        _next_pow2(-(-(nb + npr) // 16384)),
        2,
    )

    def cap_for(n):
        c = max(((-(-n // ntiles)) * 3 * cap_mult + 1) // 2, 64)
        return -(-c // 8) * 8  # 8-row aligned cells

    cap_b, cap_p = cap_for(nb), cap_for(npr)
    group = max(min(mem // (cap_b + cap_p), ntiles), 1)
    while ntiles % group:
        group -= 1
    return ntiles, cap_b, cap_p, group


def _tiled_matched_mult(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig,
    build_count,
    probe_count,
    cap_mult: int = 1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One attempt of the over-budget join: (matched, mult, overflow).

    Both sides are hash-partitioned into ``ntiles`` cells (K8, K9; only key
    words ride the cells) and ``group`` cell pairs are joined per step (K10),
    so each step's working set stays within ``cfg.mem_rows`` rows.  K10
    writes the occupied slots' counts compacted, and K9's row map of each
    probe row's slot returns them to probe order by one gather (K7).

    K9 stages at most ``cells_plan.round_width`` cells a call, so the cells
    are staged in rounds of that many: round r stages the rows whose cell
    lies in ``[r * W, (r + 1) * W)`` (the others get a destination at or
    past W as a u32, which K9 leaves unstaged), joins its pairs, and gathers
    its counts to probe order; rows of other rounds gather 0, so the rounds'
    gathers add up.  With one round (every layout K9 takes whole) this is
    one staging a side and one gather.

    Cell overflow is the sum over the rounds and is returned, not handled:
    ``hash_join_count`` retries with doubled capacity, and the result of an
    attempt that overflowed is discarded."""
    nb, npr = build.nrows, probe.nrows
    dev = build.recid.device
    ntiles, cap_b, cap_p, group = _tile_layout(nb, npr, cfg.mem_rows, cap_mult)
    width = cells_plan.round_width(nb, npr, ntiles, cap_b, cap_p)
    whole = width == ntiles
    group = min(group, width)  # both powers of two: a round is whole steps
    # ntiles is a power of two: the mask is the modulo of the unsigned hash,
    # so no destination exceeds the cells (K9's in_range, for one round)
    hb = key_hash(build, field) & (ntiles - 1)
    hp = key_hash(probe, field) & (ntiles - 1)
    bkw = key_words(build, field)
    pkw = key_words(probe, field)
    # cross-width string keys: the narrower side's missing trailing words are
    # zero by the narrow-width invariant, so both lists are zero-padded to a
    # common width before the cells compare them word by word
    nw = max(len(bkw), len(pkw))
    bkw = bkw + [torch.zeros(nb, dtype=torch.int32, device=dev)] * (nw - len(bkw))
    pkw = pkw + [torch.zeros(npr, dtype=torch.int32, device=dev)] * (nw - len(pkw))
    # the occupied slots' counts of a round, compacted: pair g's live probe
    # rows from the exclusive sum of the counts; K10 writes every one of them,
    # so nothing else of mult_slots is read.  Probe row i's count is at
    # first[c] + r for its slot c * cap_p + r; rows that were not staged in
    # the round carry 0.
    mult_slots = torch.empty(npr, dtype=torch.int32, device=dev)
    mult_rows = ovf = None
    for base in range(0, ntiles, width):
        db, dp = (hb, hp) if whole else (hb - base, hp - base)
        bcells, bcnt, _, ovf_b = stage_to_cells(db, None, width, cap_b, bkw, row_map="none",
                                                count=build_count, in_range=whole)
        pcells, pcnt, slot_p, ovf_p = stage_to_cells(dp, None, width, cap_p, pkw,
                                                     row_map="slots", count=probe_count,
                                                     in_range=whole)
        bcells = [w.view(width, cap_b) for w in bcells]
        pcells = [w.view(width, cap_p) for w in pcells]
        first = cumsum(pcnt) - pcnt
        for lo in range(0, width, group):
            hi = lo + group
            member_multiplicity_cells(
                [w[lo:hi] for w in bcells], bcnt[lo:hi], [w[lo:hi] for w in pcells],
                pcnt[lo:hi], out=mult_slots, out_pos=first[lo:hi])
        got = unpermute_gather(slot_p, mult_slots, first, cap_p, probe_count)
        mult_rows = got if mult_rows is None else mult_rows.add_(got)
        ovf = ovf_b + ovf_p if ovf is None else ovf + ovf_b + ovf_p
    return mult_rows > 0, mult_rows, ovf


def _tiled_count_impl(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    build_count=None,
    probe_count=None,
    cap_mult: int = 1,
):
    """One tiled attempt: (matched, mult, nres, overflow)."""
    field = canonical_field(field)
    matched, mult, ovf = _tiled_matched_mult(
        build, probe, field, cfg, build_count, probe_count, cap_mult)
    if field != FIELD_NUMSTR:
        mult = matched.to(torch.int32)
    return matched, mult, mult.sum(dtype=torch.int32), ovf


def _ensure_cells_fit(build: RecordBatch, probe: RecordBatch, field, cfg: EngineConfig,
                      cap_mult: int) -> None:
    """Raise before a tiled attempt whose cells cannot be staged in any
    round (a side past 2^31 - 1 rows, or a cell whose capacity alone passes
    2^31 - 1 slots: ``cells_plan.round_width``), or whose one round of cells
    the card cannot hold."""
    nb, npr = build.nrows, probe.nrows
    ntiles, cap_b, cap_p, _ = _tile_layout(nb, npr, cfg.mem_rows, cap_mult)
    try:
        width = cells_plan.round_width(nb, npr, ntiles, cap_b, cap_p)
    except ValueError as e:
        if max(nb, npr) > cells_plan.MAX_ROWS:
            raise RuntimeError(f"tiled hash join: {nb} + {npr} rows; K9 stages at most "
                               f"2^31 - 1 rows a side: {e}") from None
        raise RuntimeError(
            f"tiled hash join: the keys are too skewed for {nb} + {npr} rows: cells "
            f"overflowed up to cap_mult={cap_mult // 2}, and a cell of {cap_b} + {cap_p} rows "
            f"at cap_mult={cap_mult} cannot be staged: {e}") from None
    dev = build.recid.device
    if dev.type != "cuda":
        return
    nw = max(len(key_words(build, field)), len(key_words(probe, field)))
    # the key words of both sides' cells of one round, and the probe side's counts
    need = 4 * width * (nw * (cap_b + cap_p) + cap_p)
    free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    if need > free:
        raise RuntimeError(
            f"tiled hash join: the keys are too skewed for {nb} + {npr} rows: cells overflowed "
            f"up to cap_mult={cap_mult // 2}, and a round of {width} cells of {cap_b} + {cap_p} "
            f"rows at cap_mult={cap_mult} needs {need} bytes of cells against {free} free on "
            f"the card")


def hash_join_count(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    build_count=None,
    probe_count=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(matched, mult, nres) at any size.

    In-budget pairs take ``hash_join_count_impl``.  Pairs beyond
    ``cfg.mem_rows`` run the device-tiled passes; when a cell overflows
    (key skew) the attempt is discarded and retried with doubled cell
    capacity.  The retry is bounded: at ``cap_mult = ntiles`` a cell holds a
    whole side and cannot overflow, so there are at most log2(ntiles) + 1
    attempts, each overflow is logged, and running out of them raises.

    The number of cells stays fixed while their capacity doubles, so heavy
    skew at a large size ends earlier: an attempt whose one cell would pass
    2^31 - 1 slots, or whose round of cells would pass the card's free
    memory, is not made and a ``RuntimeError`` names the skew and the size
    reached."""
    if build.nrows + probe.nrows <= cfg.mem_rows:
        return hash_join_count_impl(build, probe, field, cfg, build_count, probe_count)
    ntiles = _tile_layout(build.nrows, probe.nrows, cfg.mem_rows)[0]
    attempts = ntiles.bit_length()  # log2(ntiles) + 1: ntiles is a power of two
    cap_mult = 1
    for attempt in range(1, attempts + 1):
        _ensure_cells_fit(build, probe, field, cfg, cap_mult)
        matched, mult, nres, ovf = _tiled_count_impl(
            build, probe, field, cfg, build_count, probe_count, cap_mult)
        ovf = int(ovf)
        if ovf == 0:
            if attempt > 1:
                log.info("tiled hash join: done in %d attempts (cap_mult=%d)", attempt, cap_mult)
            return matched, mult, nres
        log.warning(
            "tiled hash join: %d rows overflowed their cells at cap_mult=%d "
            "(attempt %d of %d); doubling the cell capacity", ovf, cap_mult, attempt, attempts)
        cap_mult *= 2
    raise RuntimeError(
        f"tiled hash join: cells still overflow after {attempts} attempts "
        f"(ntiles={ntiles}, cap_mult={cap_mult // 2})")


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
    # the default config, as the JAX package compacts here: the gather route
    # under every engine (the result is the same on both routes)
    out, _, _ = compact_rows(probe, matched)
    return out, nres


def hash_join(
    build: RecordBatch,
    probe: RecordBatch,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor]:
    """Semi-join at any size.  Pairs beyond ``cfg.mem_rows`` get their match
    mask from the tiled ``hash_join_count`` and materialize through
    budget-sized gather chunks (``ops/chunked.py``)."""
    if build.nrows + probe.nrows <= cfg.mem_rows:
        return hash_join_impl(build, probe, field, cfg)
    from .chunked import compact_rows_chunked

    matched, _, nres = hash_join_count(build, probe, field, cfg)
    out, _ = compact_rows_chunked(probe, matched, cfg)
    return out, nres


def materialize_field3_device(
    probe: RecordBatch, mult: torch.Tensor, cap: int
) -> tuple[RecordBatch, torch.Tensor]:
    """Device-side segmented expansion: emit probe row j ``mult[j]`` times.

    The reference's field-3 multimap emits one probe row per matching build
    (num, str) pair (``DatabaseProject.cpp:619-628``).  The output size
    depends on the data, so the result has ``cap`` rows and the true total
    comes with it, a 0-d int32 tensor on the device: output row i (i <
    total) is probe row ``searchsorted(cumsum(mult), i, 'right')``, the
    engine's only primitive that duplicates rows.  Rows past the total are
    zero with valid False; ``total > cap`` means the caller's capacity was
    too small (run again with cap = total).  The cumsum is K2, the sources
    K14 (``kernels/expand_sources.py``), the gather K4 with the total as its
    live count."""
    c = cumsum(mult.to(torch.int32))
    total = c[-1] if probe.nrows else torch.zeros((), dtype=torch.int32, device=c.device)
    src = expand_sources(c, total, cap)
    return probe.take_fill(src, count=total), total


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
