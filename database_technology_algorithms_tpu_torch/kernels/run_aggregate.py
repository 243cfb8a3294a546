"""K13: the run aggregate (``csrc/run_aggregate.cu``) and its plain torch
version.

Replaces the scans, compaction and differences of the JAX package's
``_run_aggregates`` (``ops/aggregate.py:46-75``).

The kernel's plan: tiles of ``TILE_ROWS`` rows, ``THREADS`` threads a
block, ``ITEMS`` consecutive rows a thread; one pass that derives the run
starts from ``active_s`` and ``adj`` itself and finds each tile's group
offset and the aggregate of the group still open at its start by decoupled
look-back over the earlier tiles' records (``scan_plan.WINDOW`` at a time,
back to the first inclusive prefix); the row that ends a group stores its
four words, and a tile without an active row reads no measure.  A second
launch writes the identities to the rows past ``n_groups``.  The scratch
(``agg_scratch_words``): the tile counter and a state word a tile, zeroed
by one memset, then two payloads of ``PART_WORDS`` a tile.
``tests/test_torch_aggregate.py`` emulates the plan on the CPU.
"""

from __future__ import annotations

import torch

from ..batch import U32_MASK, as_u32, u32_bits
from . import _lib, scan_plan
from .compact import compact_words_plain
from .seg_scan import seg_scan_plain

THREADS = 256  # a block (THREADS in csrc/run_aggregate.cu)
ITEMS = 16  # consecutive rows a thread (ITEMS)
TILE_ROWS = THREADS * ITEMS  # rows a block (TILE)
PART_WORDS = 8  # a tile's payload: starts, count, sum, min, max, 3 unused (PART_WORDS)
MAX_ROWS = (1 << 31) - 1  # group ids are int32
AGG_NAMES = ("count", "sum", "min", "max")
_IDENTITY = (0, 0, -1, 0)  # count, sum, U32_MAX as int32 bits, 0


def _measures(vals: tuple) -> tuple:
    if len(vals) not in (1, 4):
        raise ValueError(f"run_aggregate: 1 measure (num) or 4 partials, got {len(vals)}")
    return vals


def agg_scratch_words(n: int) -> int:
    """K13's scratch in 32-bit words: the tile counter and a state word a
    tile, padded to 8 words, then an aggregate and an inclusive prefix of
    ``PART_WORDS`` a tile."""
    t = scan_plan.tiles(n, TILE_ROWS)
    return -(-(1 + t) // 8) * 8 + 2 * PART_WORDS * t


def run_aggregate(active_s: torch.Tensor, adj: torch.Tensor, vals: tuple
                  ) -> tuple[dict, torch.Tensor]:
    """Per run of equal keys over rows in sorted order: (aggs, n_groups).

    `active_s` and `adj` are bool[N] (the sorted activity and the view's
    ``adj_eq``); group g is the g-th run of ``new_run = active_s & ~adj``.
    `vals` is ``(num,)``, whose sum, min and max are taken with a count of 1
    a row, or the four partial columns ``(count, sum, min, max)``; int32
    tensors holding u32 bits.  ``aggs`` maps "count" (int32 sum, wrapping),
    "sum" (u32 sum mod 2^32), "min" and "max" (unsigned) to [N] int32
    columns, group-major, holding 0, 0, U32_MAX and 0 past ``n_groups``, a
    0-d int32 tensor on the device.

    CPU tensors take the plain version; CUDA tensors launch the kernel (a
    memset of its scratch's head, the pass over the rows, the identities
    past ``n_groups``).
    """
    vals = _measures(tuple(vals))
    if active_s.device.type == "cpu":
        return run_aggregate_plain(active_s, adj, vals)
    dev = active_s.device
    n = active_s.shape[0]
    _lib.check_cuda("run_aggregate active_s", active_s, torch.bool)
    _lib.check_cuda("run_aggregate adj", adj, torch.bool, dev)
    for v in vals:
        _lib.check_cuda("run_aggregate vals", v, torch.int32, dev)
    if any(t.shape != (n,) for t in (adj, *vals)):
        raise ValueError("run_aggregate: adj and vals must be [N] like active_s")
    if n > MAX_ROWS:
        raise ValueError(f"run_aggregate: {n} rows; group ids are int32 (at most 2^31 - 1)")
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    n_groups = torch.empty((), dtype=torch.int32, device=dev)
    words = agg_scratch_words(n)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_run_aggregate(
            active_s.data_ptr(), adj.data_ptr(), _lib.ptr_array(vals), len(vals), n,
            out.data_ptr(), n_groups.data_ptr(), scratch.data_ptr(), words,
            _lib.stream_of(active_s),
        )
    _lib.raise_on_error(err, "run_aggregate")
    _lib.LAUNCHES["run_aggregate"] += 1
    return dict(zip(AGG_NAMES, out)), n_groups


def run_aggregate_plain(active_s: torch.Tensor, adj: torch.Tensor, vals: tuple
                        ) -> tuple[dict, torch.Tensor]:
    """The JAX package's composition in plain torch: inclusive cumsums of
    the counts and sums, segmented min and max from the run starts, a
    compaction of the four words at the run ends, and differences of
    neighbours (u32 wrap through ``as_u32``/``u32_bits``)."""
    vals = _measures(tuple(vals))
    n, dev = active_s.shape[0], active_s.device
    if len(vals) == 1:
        ones = torch.ones(n, dtype=torch.int32, device=dev)
        vals = (ones, vals[0], vals[0], vals[0])
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return {k: empty.clone() for k in AGG_NAMES}, torch.zeros((), dtype=torch.int32,
                                                                  device=dev)
    count_vals, sum_vals, min_vals, max_vals = vals
    new_run = active_s & ~adj
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    nxt_active = torch.cat([active_s[1:], no])
    nxt_same = torch.cat([adj[1:], no])
    is_end = active_s & (~nxt_active | ~nxt_same)
    c_incl = seg_scan_plain(None, torch.where(active_s, count_vals, 0), "add")
    s_incl = seg_scan_plain(None, torch.where(active_s, sum_vals, 0), "add")
    run_min = seg_scan_plain(new_run, torch.where(active_s, min_vals, -1), "min")
    run_max = seg_scan_plain(new_run, torch.where(active_s, max_vals, 0), "max")
    n_groups = new_run.sum(dtype=torch.int32)
    _, (ec, es, emin, emax) = compact_words_plain(is_end, (c_incl, s_incl, run_min, run_max))
    live_g = torch.arange(n, device=dev) < n_groups
    zero = torch.zeros(1, dtype=torch.int32, device=dev)

    def diff(e):
        return u32_bits((as_u32(e) - as_u32(torch.cat([zero, e[:-1]]))) & U32_MASK)

    cols = (diff(ec), diff(es), emin, emax)
    return {k: torch.where(live_g, c, fill) for k, c, fill in zip(AGG_NAMES, cols, _IDENTITY)
            }, n_groups
