"""The probes of the repository's ``tools/`` that hold Pallas kernels, on the
card: ``bench_pallas_dma`` (K11) and ``bench_permute_prims`` (K12, and the
library calls that stand for its XLA measurements P1-P3).  Each
runs as ``python -m database_technology_algorithms_tpu_torch.tools.<name>``,
on the card, or with ``--cpu`` through the plain versions for correctness
only.  ``radix_phases`` times the phases of the one-sweep radix pass (K1, K5)
tile by tile, ``rowmove_sweep`` the row-move engine (K4, K12) by the rows
a block owns, ``scan_sweep`` K2's and K3's tiles, ``cells_sweep`` K9's
span and place warps and K10's shared table, and ``perm_sweep`` K6's rows a
lane and key stages and the rows a thread and grid of K7's scatter and
gather, ``copy_sweep`` K11's unit, ring and blocks an SM, and
``probe_sweep`` K15's index tree, threads and blocks an SM and K18's span
and threads, and ``hash_sweep`` K16's keys a thread, threads and window
and K21's rows a thread, threads and grid, and ``expand_sweep`` K14's
threads and merge items a thread, and ``gather_sweep`` the form and rows a
thread of K1's and K5's gather of their extra words, on the card
only; ``checkout_ab`` times named sets of calls (the tiled join; K6 and
K7's scatter; the ``pipeline`` command's K6 and K7 by field; K11 and K22;
K19 and K13 by launch; K15, K18 and their engines' ``hash_join_count``;
K16, K17, the "table" engine, K21 and the skew step; K14,
``materialize_field3_device``, K20 and the skew step's kernels;
``gather_words`` in K1's largest call and in ``group_aggregate``; K1 and K5
at the main path's shapes) of several checkouts in turn."""

from __future__ import annotations

import torch


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean time of fn() over `reps` back-to-back calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
