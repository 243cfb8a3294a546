"""database_technology_algorithms_tpu_torch — the query engine on PyTorch and CUDA.

A port of ``database_technology_algorithms_tpu`` (JAX on a TPU) to PyTorch
on an NVIDIA H100, built slice by slice; the JAX package stays the
reference and each ported function matches it bit for bit.  The port
imports no JAX.

Ported so far, on both materialization routes (gather, and the placement
route of ``EngineConfig(materialize="sort"/"sort2d")``), for all four key
fields, for device-resident tables of any size (beyond
``EngineConfig.mem_rows`` the public operators and the staged pipeline take
chunked and tiled passes): the stand-alone operators
(``ops.sort.sort_batch``, ``ops.distinct.distinct``,
``ops.merge_join.merge_join``, ``ops.hash_join.hash_join``), the staged
merge-join pipeline (``models.pipeline.make_pipeline_staged``,
``pipeline_single_impl``), the block-file codec, the seeded generator, the
``pipeline``, ``elimdup``, ``mergejoin`` and ``hashjoin`` commands, and the
probes of the repository's two Pallas kernels (``tools/``).  Its device work
runs in twelve hand-written CUDA kernels (``kernels/``, ``csrc/``).  Entry
points run on the card unless given ``device="cpu"``.
"""

from .batch import RecordBatch, canonical_field
from .config import DEFAULT_CONFIG, EngineConfig

__all__ = ["RecordBatch", "EngineConfig", "DEFAULT_CONFIG", "canonical_field"]
