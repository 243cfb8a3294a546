"""Multi-process runtime (port of the JAX package's ``parallel/multihost.py``).

The reference is strictly single-process.  The engine's multi-process form
follows the JAX package's recipe: every process calls :func:`initialize`
(a rendezvous at the coordinator), gets one global :class:`~.mesh.Mesh` of
which it holds its own shards, builds its shards of each table from the
same host columns (``dist_ops.distribute``, here also
``distribute_global``), and runs the very same distributed plan; the mesh's
collectives go over a ``torch.distributed`` process group: gloo when the
shards are on the CPU, NCCL when they are on a card, one process a card.

Failure detection, as in the JAX package: a process that never joins fails
the rendezvous after ``initialization_timeout`` seconds; a process that
dies mid-run makes its peers' next collective raise, within
``heartbeat_timeout`` seconds (the group's collective timeout) where the
lost connection does not already say so.  Both surface as raised errors,
never as a hang; recovery is re-running the failed stage
(``checkpoint.StageCheckpoints``).  The tests show the dead peer's bound
over gloo; over NCCL the group's timeout bounds a collective only through
torch's asynchronous error handling (``TORCH_NCCL_ASYNC_ERROR_HANDLING``).

The tests run two CPU processes of four shards each against a localhost
coordinator, the same code path as processes on several hosts.
"""

from __future__ import annotations

import datetime
import sys

import numpy as np

from ..batch import narrow_str_bytes, pack_str_bytes
from .dist_ops import distribute


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_devices: int | None = None, device="cuda",
               initialization_timeout: int = 300, heartbeat_timeout: int = 100):
    """Join the process group of `num_processes` processes at `coordinator`
    (``host:port``; process 0 listens there) as process `process_id`, and
    return the global mesh: `local_devices` shards (default 1) of this
    process, on its card (``cuda:process_id % device_count``, NCCL) or on
    the CPU (``device="cpu"``, gloo).

    Raises where CUDA is asked for and absent, where NCCL is not built in,
    where the rendezvous does not complete within `initialization_timeout`
    seconds, and where the group's first collective fails.  Prints the
    JAX CLI's marker ``dist: rendezvous complete, N global devices`` to
    stderr."""
    import torch
    import torch.distributed as dist

    from ..utils.checks import resolve_device
    from .mesh import Mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("multihost.initialize: this torch has no NCCL; pass "
                               "device='cpu' to run over gloo on the CPU")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"multihost.initialize: no process-group backend for {dev}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"multihost.initialize: process {process_id} of {num_processes}")
    host, _, port = coordinator.rpartition(":")
    try:
        store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                              timeout=datetime.timedelta(seconds=initialization_timeout),
                              wait_for_workers=True)
    except dist.DistError as e:  # a store that never saw every process
        raise TimeoutError(f"dist: rendezvous at {coordinator} not complete within the "
                           f"{initialization_timeout} s timeout ({num_processes} processes): "
                           f"{e}") from e
    dist.init_process_group(backend, store=store, rank=process_id, world_size=num_processes,
                            timeout=datetime.timedelta(seconds=heartbeat_timeout))
    # the group forms here: a first collective on the process's device
    probe = torch.ones(1, dtype=torch.int32, device=dev)
    dist.all_reduce(probe)
    if int(probe) != num_processes:
        raise RuntimeError(f"dist: the group's first sum is {int(probe)}, not {num_processes}")
    mesh = Mesh((dev,) * (local_devices or 1), process_index=process_id,
                process_count=num_processes, group=dist.group.WORLD)
    print(f"dist: rendezvous complete, {mesh.size} global devices", file=sys.stderr, flush=True)
    return mesh


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


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


# The JAX package's name for the multi-process form of ``distribute``, which
# already builds only this process's shards from the same host columns.
distribute_global = distribute
