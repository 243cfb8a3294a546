"""Engine configuration (PyTorch port of ``database_technology_algorithms_tpu.config``).

The fields and defaults are the JAX package's, so one ``EngineConfig`` reads
the same in both.  Only the knobs the ported slice reads have an effect
here; the others are carried so that a config written for the JAX package
means the same thing once their modules are ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # --- memory discipline (the nmem_blocks heir) ---------------------------
    # Rows the engine may hold on-device per operator instance.
    mem_rows: int = 16 * 1024 * 1024

    # --- sort ---------------------------------------------------------------
    str_prefix_words: int = 2
    # True: (inactive, key, row) views go through the packed view sort
    # (ops/sort.packed_u32_view_sort); False: the 3-word form
    # (ops/sort.view_sort_3key).  Both give the same order.
    packed_u32_sorts: bool = True
    # row-movement engine: "gather" and "auto" take the gather route
    # (compaction + record gather) on every torch device; "sort" and
    # "sort2d" are the TPU's placement-sort routes, not ported yet.
    materialize: str = "auto"

    # --- hash join ----------------------------------------------------------
    hash_load_factor_inv: int = 2
    hash_max_probe: int = 64
    # only the generic (sort-based) engines are ported; another value raises
    u32_join_engine: str = "generic"
    u32_distinct_engine: str = "generic"

    # --- distributed --------------------------------------------------------
    mesh_axis: str = "shard"
    shuffle_slack: float = 2.0
    shuffle_rank_engine: str = "auto"
    shuffle_nchunks: int = 1
    dist_join_engine: str = "sorted"
    hh_factor: int = 4
    hh_topk: int = 16

    # --- misc ---------------------------------------------------------------
    seed: int = 42
    debug_checks: bool = False


DEFAULT_CONFIG = EngineConfig()
