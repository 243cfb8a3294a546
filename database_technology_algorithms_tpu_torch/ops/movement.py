"""Word-level data movement.

Port of the gather route of the JAX package's ``ops/movement.py``.  The
JAX package moves rows through placement sorts on the TPU, where it found
random gathers slow, and through a compaction plus one record gather
elsewhere (``config.py``: "gather … fast on CPU/GPU").  The port takes the
gather route: ``compact_words`` is kernel K3, the record gather kernel K4.
``stage_to_cells`` and ``value_boundaries``, the partition pass of the tiled
over-budget join, are kernel K9 (``kernels/stage_cells.py``).
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.compact import compact_words
from ..kernels.stage_cells import stage_to_cells, value_boundaries
from .scan import cumsum

__all__ = [
    "compact_words", "compaction_dest", "compact_rows", "use_sort_placement",
    "stage_to_cells", "value_boundaries",
]


def use_sort_placement(cfg: EngineConfig = DEFAULT_CONFIG) -> bool:
    """The row-movement engine: False (the gather route) for "gather" and
    "auto" on every torch device.  The placement-sort routes are not
    ported yet and raise."""
    if cfg.materialize in ("sort", "sort2d"):
        raise NotImplementedError(
            f"materialize={cfg.materialize!r}: the placement-sort route is not "
            "ported yet (ROADMAP.md, Queue 2: the materialize='sort' route)"
        )
    if cfg.materialize in ("gather", "auto"):
        return False
    raise ValueError(f"unknown materialize engine: {cfg.materialize!r}")


def compaction_dest(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dest, count): dest[i] = survivor rank if kept, else count + drop rank.

    dest is a dense permutation of [0, N): survivors to the front in order,
    drops after in order.
    """
    n = keep.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=keep.device)
    ranks = cumsum(keep.to(torch.int32)) - 1  # kept rank at kept rows
    count = keep.sum(dtype=torch.int32)
    return torch.where(keep, ranks, count + (iota - ranks - 1)), count


def compact_rows(
    batch: RecordBatch,
    keep: torch.Tensor,
    extra: tuple = (),
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[RecordBatch, torch.Tensor, tuple]:
    """Keep-masked rows to the front, order preserved; rows past `count`
    are zero with valid False.  Returns (batch, count, extras compacted
    alongside).  One word compaction (K3) and one record gather (K4)."""
    use_sort_placement(cfg)
    n = batch.nrows
    iota = torch.arange(n, dtype=torch.int32, device=keep.device)
    count, out = compact_words(keep, (iota, *extra))
    return batch.take_fill(torch.where(iota < count, out[0], n)), count, out[1:]
