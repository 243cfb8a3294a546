"""Operator statistics and bytes-moved accounting (port of the JAX
package's ``metrics.py``: its fields, with the same names and meaning).

The reference's only instrumentation is its stats-out parameters —
``nsorted_segs``, ``npasses``, ``nunique``, ``nres``, ``nios``
(``dbtproj.h:50-52,64-65,78-79,92-93``).  The engine keeps the counter
names, so the two packages' stats compare field for field, and replaces
the block-IO unit ``nios`` with bytes moved per memory tier.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class OperatorStats:
    """Per-operator stats; a superset of the reference's out-params."""

    op: str = ""
    rows_in: int = 0
    rows_out: int = 0
    # reference-compatible counters
    nsorted_segs: int = 0
    npasses: int = 0
    nunique: int = 0
    # per-side EliminateDuplicates counters (the external joins run two)
    nunique_r: int = 0
    nunique_s: int = 0
    nres: int = 0
    # bytes moved per tier (the nios heir): the device, host RAM and disk,
    # and the exchanges between shards (ICI within a host, DCN across hosts)
    bytes_hbm: int = 0
    bytes_host: int = 0
    bytes_ici: int = 0
    bytes_dcn: int = 0
    # out-of-core discipline: the largest key-range working set pass 2 ever
    # held in host RAM at once (rows); must stay O(mem_rows)
    peak_range_rows: int = 0
    # shuffle-overflow recoveries: capacity-doubling re-runs that were needed
    # before the exchange fit (0 = first attempt fit)
    retries: int = 0
    # timing
    wall_s: float = 0.0

    def merge(self, other: "OperatorStats") -> "OperatorStats":
        """A copy of self with other's passes, segments and bytes added."""
        out = dataclasses.replace(self)
        for f in ("nsorted_segs", "npasses", "bytes_hbm", "bytes_host", "bytes_ici",
                  "bytes_dcn"):
            setattr(out, f, getattr(self, f) + getattr(other, f))
        return out


class Timer:
    """Wall-clock span.  Call ``.stop()`` once the outputs are on the host
    or after ``torch.cuda.synchronize()``: the card runs asynchronously, so
    a span that ends while its kernels are queued measures their enqueue."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.elapsed = 0.0

    def stop(self) -> float:
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


def batch_bytes(nrows: int, with_strings: bool = True) -> int:
    """Device bytes of a RecordBatch of nrows at full string width
    (recid + num + valid + strs)."""
    per_row = 4 + 4 + 1 + (128 if with_strings else 0)
    return nrows * per_row
