"""Word-level data movement.

Port of the gather route of the JAX package's ``ops/movement.py``.  The
JAX package moves rows through placement sorts on the TPU, where a random
gather costs ~32 ns/row, and through a compaction plus one record gather
elsewhere (``config.py``: "gather … fast on CPU/GPU").  The port takes the
gather route: ``compact_words`` is kernel K3, the record gather kernel K4.
"""

from __future__ import annotations

from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.compact import compact_words

__all__ = ["compact_words", "use_sort_placement"]


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
