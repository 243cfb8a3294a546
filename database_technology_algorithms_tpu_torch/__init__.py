"""database_technology_algorithms_tpu_torch — the query engine on PyTorch and CUDA.

A port of ``database_technology_algorithms_tpu`` (JAX on a TPU) to PyTorch
on an NVIDIA H100, built slice by slice; the JAX package stays the
reference and each ported function matches it bit for bit.  The port
imports no JAX.

Ported so far: the staged merge-join pipeline for the u32 key fields
(``models.pipeline.make_pipeline_staged``, ``pipeline_single_impl``), the
block-file codec, the seeded generator and the ``mergejoin`` CLI.  Its
device work runs in four hand-written CUDA kernels (``kernels/``,
``csrc/``).  Entry points run on the card unless given ``device="cpu"``.
"""

from .batch import RecordBatch, canonical_field
from .config import DEFAULT_CONFIG, EngineConfig

__all__ = ["RecordBatch", "EngineConfig", "DEFAULT_CONFIG", "canonical_field"]
