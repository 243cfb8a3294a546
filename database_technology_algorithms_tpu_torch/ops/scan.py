"""Segmented scans — per-group reductions over runs in sorted order.

Port of the JAX package's ``ops/scan.py``.  Groups are contiguous runs
(flag True at each run start); every function here is one launch of the
segmented-scan kernel K2 (``kernels/seg_scan.py``).  Values are int32
tensors holding u32 words unless ``signed=True``.
"""

from __future__ import annotations

import torch

from ..kernels.seg_scan import seg_scan


def seg_carry(start_flags: torch.Tensor, vals: torch.Tensor,
              reverse: bool = False) -> torch.Tensor:
    """vals[row] := vals at the start of row's run (an add scan over the
    start-masked values, as in the JAX package).  ``reverse=True`` with the
    runs' END flags hands each row its run's last value:
    ``flip(seg_carry(flip(end_flags), flip(vals)))``."""
    masked = torch.where(start_flags, vals, 0)
    return seg_scan(start_flags, masked, "add", reverse=reverse)


def seg_min(start_flags: torch.Tensor, vals: torch.Tensor, signed: bool = False,
            reverse: bool = False) -> torch.Tensor:
    """Running min within each run (inclusive)."""
    return seg_scan(start_flags, vals, "min", signed, reverse)


def seg_max(start_flags: torch.Tensor, vals: torch.Tensor, signed: bool = False,
            reverse: bool = False) -> torch.Tensor:
    """Running max within each run (inclusive).  ``reverse=True`` with the
    runs' END flags gives ``flip(seg_max(flip(end_flags), flip(vals)))``."""
    return seg_scan(start_flags, vals, "max", signed, reverse)


def cumsum(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum, wrapping mod 2^32."""
    return seg_scan(None, vals, "add")
