"""The port's hand-written CUDA kernels (``csrc/``), bound through ctypes.

    K1 radix_sort.view_sort     <- ops/sort.py:190 packed_u32_view_sort
    K2 seg_scan.seg_scan        <- ops/scan.py:28-137 blocked scans
    K3 compact.compact_words    <- ops/movement.py:479 compact_words
    K4 take_fill.take_fill      <- batch.py:220 RecordBatch.take_fill
    K5 words_sort.words_sort    <- ops/sort.py:99,63 sort_keys, _lsd_exact_string_perm
    K6 adj_equal.adj_equal      <- ops/keys.py:68 rows_equal_on_field over (perm[:-1], perm[1:])
    K7 unpermute.unpermute      <- ops/hash_join.py:242-253, ops/movement.py:235 back-sorts
    K8 hash_words.hash_words    <- ops/keys.py:110 hash_words
    K9 stage_cells.stage_to_cells, value_boundaries
                                <- ops/movement.py:354,319 stage_to_cells, value_boundaries
    K10 member_mult.member_multiplicity_cells
                                <- ops/hash_join.py:256,459-469 member_multiplicity under vmap

(paths in the JAX package).  Each wrapper runs its plain torch version
for CPU tensors and launches its kernel for CUDA tensors, counting the
launch in ``LAUNCHES``; there is no fallback from one to the other.
"""

from ._lib import LAUNCHES, build, library, reset_launches

__all__ = ["LAUNCHES", "build", "library", "reset_launches"]
