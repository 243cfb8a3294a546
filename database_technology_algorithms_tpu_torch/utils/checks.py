"""Debug-mode invariant guards, device selection and the memory budget.

Port of the JAX package's ``utils/checks.py``:

* :func:`check_batch` / :func:`assert_batch`: host-side structural
  validation of a RecordBatch (shapes, dtypes, NUL-normalized strings,
  live-count bounds), which the CLI's ``pipeline --debug-checks`` runs on
  its inputs;
* :func:`checked_take`: a gather that refuses an index outside
  ``[0, upper]``;
* ``MemoryBudgetError`` and ``ensure_device_budget``, the in-budget gate.

``resolve_device`` is the port's one rule for where an entry point runs: on
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def check_batch(batch, count=None) -> list[str]:
    """Return a list of invariant violations (empty = healthy).  Host-side.

    The port stores every u32 word as an int32 bit pattern, so the dtypes
    expected are ``torch.int32`` for ``recid``, ``num`` and ``strw`` and
    ``torch.bool`` for ``valid`` (the JAX package's are u32 and bool)."""
    from ..batch import STR_WIDTH_BUCKETS, torch_to_u32, unpack_str_words

    problems: list[str] = []
    n = batch.nrows
    if tuple(batch.num.shape) != (n,):
        problems.append(f"num shape {tuple(batch.num.shape)} != ({n},)")
    if (
        batch.strw.dim() != 2
        or batch.strw.shape[0] != n
        or batch.strw.shape[1] not in STR_WIDTH_BUCKETS
    ):
        problems.append(
            f"strw shape {tuple(batch.strw.shape)} != ({n}, K) for K in {STR_WIDTH_BUCKETS}"
        )
    if tuple(batch.valid.shape) != (n,):
        problems.append(f"valid shape {tuple(batch.valid.shape)} != ({n},)")
    for name, col in (("recid", batch.recid), ("num", batch.num), ("strw", batch.strw)):
        if col.dtype != torch.int32:
            problems.append(f"{name} dtype {col.dtype} != {torch.int32}")
    if batch.valid.dtype != torch.bool:
        problems.append(f"valid dtype {batch.valid.dtype} != bool")
    if count is not None:
        c = int(count)
        if not (0 <= c <= n):
            problems.append(f"live count {c} outside [0, {n}]")
    # NUL-normalization: no nonzero byte may follow the first NUL
    # (strcmp-order equivalence depends on it); the bytes in the order
    # pack_str_bytes wrote them
    if batch.strw.dim() == 2 and batch.strw.dtype == torch.int32:
        strs = unpack_str_words(torch_to_u32(batch.strw))
        seen_nul = np.cumsum(strs == 0, axis=1) > 0
        if np.any(strs[seen_nul] != 0):
            bad = int(np.any(strs * seen_nul != 0, axis=1).sum())
            problems.append(f"{bad} rows have bytes after the first NUL")
    return problems


def assert_batch(batch, count=None) -> None:
    problems = check_batch(batch, count)
    if problems:
        raise AssertionError("RecordBatch invariants violated: " + "; ".join(problems))


def checked_take(col: torch.Tensor, idx: torch.Tensor, upper: int) -> torch.Tensor:
    """Guarded gather: raises ``IndexError`` naming the largest index if any
    index lies outside ``[0, upper]``; otherwise ``col`` at the indices
    clipped to its rows (``jnp.take(mode="clip")``).  The JAX package checks
    with ``checkify``; here one flag comes back to the host, a sync that a
    debug check may cost (a device-side assert would end the CUDA context)."""
    if bool(((idx < 0) | (idx > upper)).any()):
        hi = int(idx.max())
        if hi > upper:
            raise IndexError(f"index out of bounds: max {hi} > {upper}")
        raise IndexError(f"index out of bounds: min {int(idx.min())} < 0")
    return col[idx.long().clamp(0, max(col.shape[0] - 1, 0))]


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
