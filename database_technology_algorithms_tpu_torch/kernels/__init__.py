"""The port's hand-written CUDA kernels (``csrc/``), bound through ctypes.

    K1 radix_sort.view_sort     <- ops/sort.py:190 packed_u32_view_sort
    K2 seg_scan.seg_scan        <- ops/scan.py:28-137 blocked scans
    K3 compact.compact_words    <- ops/movement.py:479 compact_words
    K4 take_fill.take_fill      <- batch.py:220 RecordBatch.take_fill
    K5 words_sort.words_sort    <- ops/sort.py:99,63 sort_keys, _lsd_exact_string_perm
    K6 adj_equal.adj_equal      <- ops/keys.py:68 rows_equal_on_field over (perm[:-1], perm[1:])
    K7 unpermute.unpermute      <- ops/hash_join.py:242-253, ops/movement.py:235 back-sorts
       unpermute.unpermute_gather
                                <- ops/hash_join.py:470-489 the tiled join's return to probe order
    K8 hash_words.hash_words    <- ops/keys.py:110 hash_words
    K9 stage_cells.stage_to_cells, value_boundaries
                                <- ops/movement.py:354,319 stage_to_cells, value_boundaries
    K10 member_mult.member_multiplicity_cells
                                <- ops/hash_join.py:256,459-469 member_multiplicity under vmap
    K11 tile_copy.tile_copy     <- tools/bench_pallas_dma.py:43,73 make_kernel (Pallas)
    K12 row_move.row_move       <- tools/bench_permute_prims.py:155,176 make_rowmove (Pallas);
                                   the placement route's word gather (ops/movement.py:51,68,108)
    K13 run_aggregate.run_aggregate
                                <- ops/aggregate.py:46-75 _run_aggregates' scans and compaction
    K14 expand_sources.expand_sources
                                <- ops/hash_join.py:682-686 materialize_field3_device's search
    K15 sorted_probe.sorted_probe
                                <- ops/fastpath.py:101-104 hash_join_count_u32's searchsorted probe
    K16 hash_set.hash_set_build <- ops/hash_table.py:50 build_hash_set
    K17 hash_set.hash_set_probe <- ops/hash_table.py:108 probe_hash_set
    K18 bucket_probe.bucket_probe
                                <- ops/bucket_join.py:59-158 the bucket table and compare
    K19 topk_runs.topk_runs     <- parallel/skew.py:44-65 local_topk_hashes' run counts and top_k
    K20 hot_set.hot_lists, hot_hashes
                                <- parallel/skew.py:68-88 hot_hash_set's candidate reduction
                                   (both sides of the skew join in one launch)
    K21 hot_set.in_hot_set      <- parallel/skew.py:91 in_hash_set
    K22 range_dest.range_dest   <- parallel/dist_ops.py:312,380 _lex_ge and its sum

(paths in the JAX package; K11 and K12's in the repository's ``tools/``).
K1 and K5 run on one one-sweep LSD radix sort (``csrc/radix.cuh``), whose
pass schedule ``radix_plan`` builds; K4 and K12 on one row-move engine
(``csrc/rowmove.cuh``), whose access width and rows a block
``rowmove_plan`` chooses; K2 and K3 (and the scan of K9's count matrix) on
one tile layout (``csrc/scan.cuh``), whose tile and scratch ``scan_plan``
holds, as it holds K14's merge-path block; K9's span and place warps and K10's tables follow ``cells_plan``;
K6's rows a lane and key stages and the rows a thread and grid of K7's
gather follow ``perm_plan``; K15-K18's plans and limits are in ``engines_plan``,
K19-K22's in ``dist_plan``.  The distributed plan's shuffle packs with K9
(``stage_to_cells``; with a fill value for the key-only pack).
Each wrapper runs its plain torch version for CPU tensors and launches its
kernel for CUDA tensors, counting the launch in ``LAUNCHES``; there is no
fallback from one to the other.
"""

from ._lib import LAUNCHES, build, library, reset_launches

__all__ = ["LAUNCHES", "build", "library", "reset_launches"]
