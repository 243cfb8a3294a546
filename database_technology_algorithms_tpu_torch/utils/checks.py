"""Device selection and the device memory budget.

``MemoryBudgetError`` and ``ensure_device_budget`` are the JAX package's
(``utils/checks.py``); ``resolve_device`` is the port's one rule for where
an entry point runs: on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


class MemoryBudgetError(ValueError):
    """An in-memory operator was handed more rows than the device budget."""


def ensure_device_budget(nrows: int, cfg, op: str) -> None:
    """Refuse inputs beyond ``cfg.mem_rows`` (the reference's nmem_blocks
    bounded-buffer contract, ``dbtproj.h:48,76``).  This is the gate of the
    in-budget ``_impl`` forms; the public operators route such inputs
    instead of calling them."""
    if nrows > cfg.mem_rows:
        raise MemoryBudgetError(
            f"{op}: {nrows} rows exceed the device budget "
            f"cfg.mem_rows={cfg.mem_rows}; use the public sort_batch, distinct, "
            f"hash_join_count, hash_join or make_pipeline_staged, which route "
            f"device-resident inputs of any size through chunked and tiled passes "
            f"(ops/chunked.py, the tiled join of ops/hash_join.py); block files "
            f"beyond the budget go through the external drivers of external.py, "
            f"and the CLI's file commands route them there themselves"
        )


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    There is no silent fallback: asking for CUDA (explicitly or by default)
    where CUDA is unavailable raises.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
