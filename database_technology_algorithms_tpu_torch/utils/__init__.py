"""Utilities: roofline audit, profiling, device selection and checks."""

from .profiling import annotate, timed, trace
from .roofline import audit, chip_hbm_gbps, report

__all__ = ["audit", "chip_hbm_gbps", "report", "timed", "trace", "annotate"]
