"""Roofline audit: measured rows/s against the card's memory-rate bound.

Port of the JAX package's ``utils/roofline.py``.  Every operator of the
engine moves integer keys and records (compares, hashes, scans; no tensor
core math), so bytes a second is the ceiling.  ``min_bytes`` models the
least traffic each operator must move through device memory (one read and
one write of the live data a logical pass), not what the implementation
moves, so a ``fraction_of_sol`` below 1 also shows algorithmic overhead.

The peaks name NVIDIA cards only, by ``torch.cuda.get_device_name``.  A CUDA
device whose name is not in the table raises ``ValueError``: the port does
not guess a bound.  The ``"cpu"`` entry is nominal, so that the tests run.
"""

from __future__ import annotations

import dataclasses

import torch

# peak device memory rate a card, GB/s (vendor data sheets)
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,  # H100 SXM5, NVIDIA data sheet
    "cpu": 50.0,  # nominal, for the tests only
}
# peak rate of 32-bit operations outside the tensor cores, operations a
# second: the data sheet's float32 rate, taken for the integer work of the
# kernels too
OPS_PER_S = {
    "NVIDIA H100 80GB HBM3": 67e12,
}
# peak dense tensor-core rate by operand type, operations a second (a
# multiply-add is two): NVIDIA's H100 SXM5 data sheet, without sparsity; the
# probes' one-hot products read it (tools/bench_permute_prims.py)
TENSOR_OPS_PER_S = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "int8": 1979e12},
}


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for the nominal CPU entry")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _card_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device)


def peak_for(name: str, table: dict) -> float:
    """The entry of `table` for the card called `name`; ``ValueError``
    naming the card where there is none."""
    if name not in table:
        raise ValueError(f"no peak is on record for {name!r}: add the card's data-sheet figure "
                         f"to utils/roofline.py (known: {sorted(table)})")
    return table[name]


def chip_hbm_gbps(device=None) -> float:
    """Peak memory rate of `device` in GB/s (default: the current CUDA
    device); the nominal entry for a CPU device."""
    dev = _device(device)
    if dev.type == "cpu":
        return HBM_GBPS["cpu"]
    return peak_for(_card_name(dev), HBM_GBPS)


def chip_ops_per_s(device=None) -> float:
    """Peak 32-bit operation rate of a CUDA `device` (default: the current
    one), operations a second."""
    return peak_for(_card_name(_device(device)), OPS_PER_S)


def chip_tensor_ops_per_s(kind: str, device=None) -> float:
    """Peak dense tensor-core rate of a CUDA `device` (default: the current
    one) for operands of `kind` ("bf16" or "int8"), operations a second."""
    return peak_for(_card_name(_device(device)), TENSOR_OPS_PER_S)[kind]


ROW_BYTES_FULL = 4 + 4 + 128 + 1  # recid + num + strs(padded) + valid
ROW_BYTES_KEY = 8  # key word + row index


@dataclasses.dataclass
class RooflineResult:
    op: str
    rows: int
    wall_s: float
    model_bytes: int
    achieved_gbps: float
    sol_gbps: float
    fraction_of_sol: float
    rows_per_s: float

    def line(self) -> str:
        return (
            f"{self.op:28s} {self.rows:>10,d} rows  {self.wall_s*1e3:8.2f} ms  "
            f"{self.achieved_gbps:7.1f} GB/s  {100*self.fraction_of_sol:5.1f}% of "
            f"{self.sol_gbps:.0f} GB/s SoL  ({self.rows_per_s/1e6:.2f} M rows/s)"
        )


def min_bytes(op: str, rows: int, payload_bytes: int = ROW_BYTES_FULL) -> int:
    """Least device-memory traffic of an operator (read and write of its
    live data)."""
    if op in ("filter", "compact", "scan"):
        return 2 * rows * payload_bytes
    if op in ("sort", "sort_batch"):
        # one read and write of (key, index) for the permutation, and one of
        # the payload to apply it
        return 2 * rows * ROW_BYTES_KEY + 2 * rows * payload_bytes
    if op in ("distinct",):
        return min_bytes("sort", rows, payload_bytes) + 2 * rows * payload_bytes
    if op in ("hash_join", "hash_join_count"):
        # build read + probe read + output write (probe-sized worst case)
        return 2 * rows * payload_bytes + rows * payload_bytes
    if op in ("merge_join", "join_sorted_distinct"):
        return 3 * rows * payload_bytes
    if op in ("aggregate", "group_aggregate"):
        return min_bytes("sort", rows, payload_bytes)
    if op in ("shuffle", "all_to_all"):
        return 4 * rows * payload_bytes  # pack + exchange + unpack
    if op in ("pipeline",):
        # rows = per-table rows: read both tables and write the join output
        # (at most one table's size)
        return 3 * rows * payload_bytes
    return 2 * rows * payload_bytes


def audit(
    op: str,
    rows: int,
    wall_s: float,
    payload_bytes: int = ROW_BYTES_FULL,
    device=None,
) -> RooflineResult:
    sol = chip_hbm_gbps(device)
    mb = min_bytes(op, rows, payload_bytes)
    achieved = mb / wall_s / 1e9 if wall_s > 0 else 0.0
    return RooflineResult(
        op=op,
        rows=rows,
        wall_s=wall_s,
        model_bytes=mb,
        achieved_gbps=achieved,
        sol_gbps=sol,
        fraction_of_sol=achieved / sol if sol else 0.0,
        rows_per_s=rows / wall_s if wall_s else 0.0,
    )


def report(results: list[RooflineResult]) -> str:
    lines = [
        f"roofline vs {results[0].sol_gbps:.0f} GB/s HBM"
        if results
        else "roofline (no results)"
    ]
    lines += [r.line() for r in results]
    return "\n".join(lines)
