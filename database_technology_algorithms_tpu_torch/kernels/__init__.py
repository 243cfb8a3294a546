"""The port's hand-written CUDA kernels (``csrc/``), bound through ctypes.

    K1 radix_sort.view_sort     <- ops/sort.py:190 packed_u32_view_sort
    K2 seg_scan.seg_scan        <- ops/scan.py:28-137 blocked scans
    K3 compact.compact_words    <- ops/movement.py:479 compact_words
    K4 take_fill.take_fill      <- batch.py:220 RecordBatch.take_fill

(paths in the JAX package).  Each wrapper runs its plain torch version
for CPU tensors and launches its kernel for CUDA tensors, counting the
launch in ``LAUNCHES``; there is no fallback from one to the other.
"""

from ._lib import LAUNCHES, build, library, reset_launches

__all__ = ["LAUNCHES", "build", "library", "reset_launches"]
