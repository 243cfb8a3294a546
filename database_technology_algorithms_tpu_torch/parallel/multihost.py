"""Multi-process runtime (port of the JAX package's ``parallel/multihost.py``).

Only the block partition of host columns, :func:`pad_columns`, is ported:
``dist_ops.distribute`` uses it.  The multi-process entry, a
``torch.distributed`` process group carrying the mesh's three collectives
(gloo on the CPU, NCCL across cards), is the next slice of the port;
:func:`initialize` and :func:`distribute_global` raise until then.
"""

from __future__ import annotations

import numpy as np

from ..batch import narrow_str_bytes, pack_str_bytes

MULTI_PROCESS = ("the multi-process plan (a torch.distributed process group carrying the "
                 "mesh's collectives) is not ported yet; this port runs --dist N as N shards "
                 "in one process")


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_devices: int | None = None, platform: str | None = None,
               initialization_timeout: int = 300, heartbeat_timeout: int = 100) -> None:
    """Join the multi-process runtime: not ported yet."""
    raise NotImplementedError(f"multihost.initialize: {MULTI_PROCESS}")


def pad_columns(cols: dict, ndev: int, per: int) -> tuple[dict, np.ndarray]:
    """Block-partition host columns: shard d's live rows at [d*per, d*per+c_d).

    Returns (padded columns: recid, num, valid and the packed u32 string
    words ``strw`` at the columns' narrow width; per-shard live counts)."""
    n = len(cols["recid"])
    counts = np.minimum(np.maximum(n - per * np.arange(ndev), 0), per).astype(np.int32)

    def pad(a):
        out = np.zeros((ndev * per,) + a.shape[1:], dtype=a.dtype)
        off = 0
        for d in range(ndev):
            c = counts[d]
            out[d * per: d * per + c] = a[off: off + c]
            off += c
        return out

    valid = cols.get("valid")
    if valid is None:
        valid = np.ones(n, dtype=bool)
    # narrow-width storage: the width derives from the whole table's content,
    # so every shard stores the same width
    strs = narrow_str_bytes(np.asarray(cols["strs"], np.uint8))
    padded = {
        "recid": pad(np.asarray(cols["recid"], np.uint32)),
        "num": pad(np.asarray(cols["num"], np.uint32)),
        "strw": pad(pack_str_bytes(strs)),
        "valid": pad(np.asarray(valid, bool)),
    }
    return padded, counts


def distribute_global(mesh, cols: dict, rows_per_chip: int | None = None):
    """The multi-process form of ``dist_ops.distribute``: not ported yet."""
    raise NotImplementedError(f"multihost.distribute_global: {MULTI_PROCESS}")
