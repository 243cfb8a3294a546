"""The shard mesh (port of the JAX package's ``parallel/mesh.py``).

The engine's only parallel axis is data partitioning: tables are split by
row across shards, and every distributed operator returns the same row
multisets and counters as its single-device form.  In the JAX package a
mesh is a grid of devices and a table a global array sharded over it; the
per-chip code runs inside ``shard_map`` and calls XLA collectives.

Here a :class:`Mesh` is an ordered list of global shards, of which this
process holds ``local_shards`` (global shard d = process p x local shards
+ j, host-major, as JAX's ``("host", "chip")`` mesh orders them), each on
a ``torch.device``.  Devices may repeat: four shards on the one card of a
machine, or eight on the CPU, are a mesh like four cards.  The per-shard
code is a function over the list of the process's shards, split at its
collectives, and the mesh offers the three collectives the operators use,
each taking and returning one tensor a local shard:

    all_to_all  tiled: block d of shard s goes to block s of shard d
    all_gather  tiled: every shard gets the shards' tensors concatenated
    psum        every shard gets the sum

Without a process group (one process holds every shard) each is a set of
copies onto the shards' devices (peer copies between cards, none on one
device).  With one (``parallel/multihost.initialize``: gloo when the
shards are on the CPU, NCCL when they are on a card, one process a card)
each is one ``torch.distributed`` collective over the processes, on the
process's one device; a sum of int32 words is taken in int64 and wrapped
mod 2^32, as XLA's int32 sum wraps, whatever the backend does on overflow.
Nothing above this module depends on which one runs, apart from taking the
process's own shards (``local_shards``).

The axis names and shape are JAX's: ``("shard",)``, or ``("host", "chip")``
from :func:`make_host_chip_mesh`; they feed the ``bytes_dcn`` accounting
only.  ``row_sharding`` and ``replicated`` have no counterpart: a shard's
rows are its own ``RecordBatch`` (``dist_ops.DistTable``), and a replicated
value is the list of one copy a local shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from ..batch import u32_bits
from ..utils.checks import resolve_device

SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Global shards in mesh order, with JAX's axis names and sizes (their
    product is the number of shards, host-major on a 2-D mesh); `devices`
    are this process's shards' devices, and `group` the process group that
    carries the collectives (None: one process, every shard local)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (SHARD_AXIS,)
    axis_sizes: tuple[int, ...] = ()
    process_index: int = 0
    process_count: int = 1
    group: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        n = len(self.devices) * self.process_count
        if not self.axis_sizes:
            object.__setattr__(self, "axis_sizes", (n,))
        if math.prod(self.axis_sizes) != n or not self.devices:
            raise ValueError(f"mesh of {len(self.devices)} shards a process x "
                             f"{self.process_count} processes with axes "
                             f"{dict(zip(self.axis_names, self.axis_sizes))}")
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process {self.process_index} of {self.process_count}")
        if self.group is None and self.process_count > 1:
            raise ValueError("a mesh over several processes needs their process group")
        if self.group is not None and len(set(self.devices)) != 1:
            raise ValueError(f"a process of a process-group mesh drives one device, not "
                             f"{sorted(set(map(str, self.devices)))}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of global shards."""
        return len(self.devices) * self.process_count

    @property
    def local_shards(self) -> range:
        """The global indices of this process's shards, in mesh order."""
        n = len(self.devices)
        return range(self.process_index * n, (self.process_index + 1) * n)

    def _check(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        xs = list(xs)
        if len(xs) != len(self.devices):
            raise ValueError(f"a collective takes one tensor a shard of this process: "
                             f"{len(xs)} for {len(self.devices)} shards")
        return xs

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Tiled all-to-all over dim 0: each shard's tensor is ndev equal
        blocks, and block d of shard s becomes block s of shard d."""
        xs = self._check(xs)
        n = self.size
        rows = xs[0].shape[0]
        if rows % n:
            raise ValueError(f"all_to_all: {rows} rows do not split into {n} blocks")
        b = rows // n
        if self.group is not None:
            return self._group_all_to_all(xs, b)
        return [torch.cat([x[d * b:(d + 1) * b].to(dev) for x in xs])
                for d, dev in enumerate(self.devices)]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Tiled all-gather over dim 0: every shard gets the shards' tensors
        concatenated in mesh order (one copy a device, shared by its
        shards; collective results are read, never written)."""
        xs = self._check(xs)
        if self.group is not None:
            import torch.distributed as dist

            local = _wire(torch.cat(xs))
            parts = [torch.empty_like(local) for _ in range(self.process_count)]
            dist.all_gather(parts, local, group=self.group)
            return [_unwire(torch.cat(parts), xs[0].dtype)] * len(xs)
        made: dict = {}
        for dev in self.devices:
            if dev not in made:
                made[dev] = torch.cat([x.to(dev) for x in xs])
        return [made[dev] for dev in self.devices]

    def per_device(self, fn, *xs: Sequence) -> list:
        """fn once for each device and arguments (each of `xs` a value a
        local shard): shards of one device that pass the very same objects,
        as a collective's results are, share one result (read, never
        written); a shard whose arguments differ gets its own call."""
        cols = [self._check(x) for x in xs]
        made: dict = {}
        out = []
        for dev, args in zip(self.devices, zip(*cols)):
            key = (dev, tuple(map(id, args)))
            if key not in made:
                made[key] = fn(*args)
            out.append(made[key])
        return out

    def psum(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Every shard gets the elementwise sum, in the tensors' dtype (int32
        wraps, as in XLA)."""
        xs = self._check(xs)
        dev0 = self.devices[0]
        dtype = xs[0].dtype
        if self.group is not None:
            import torch.distributed as dist

            wide = torch.stack(xs).to(torch.int64 if dtype == torch.int32 else dtype).sum(0)
            dist.all_reduce(wide, group=self.group)
            total = u32_bits(wide) if dtype == torch.int32 else wide
            return [total] * len(xs)
        total = torch.stack([x.to(dev0) for x in xs]).sum(0, dtype=dtype)
        made = {dev0: total}
        for dev in self.devices:
            if dev not in made:
                made[dev] = total.to(dev)
        return [made[dev] for dev in self.devices]

    def _group_all_to_all(self, xs: list, b: int) -> list[torch.Tensor]:
        """One ``all_to_all_single``: process q receives, for each of its
        local shards j and each of this process's shards s, block q x L + j
        of shard s; a shard's result is its blocks in source order."""
        import torch.distributed as dist

        procs, local = self.process_count, len(xs)
        rest = tuple(xs[0].shape[1:])
        # [s, q, j, b, ...] -> [q, j, s, b, ...]: what goes to each process, in its order
        send = _wire(torch.stack(xs).reshape((local, procs, local, b) + rest)
                     .transpose(0, 1).transpose(1, 2).contiguous())
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        # [p, j, s, b, ...] -> [j, p, s, b, ...]: shard j's blocks by global source p x L + s
        got = _unwire(recv, xs[0].dtype).transpose(0, 1).reshape((local, -1) + rest)
        return [got[j] for j in range(local)]


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives carry it: bools as bytes (gloo and NCCL
    take no bool)."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


def _device(d) -> torch.device:
    """A device a shard may lie on, a card named by its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _shard_devices(n: int | None, devices) -> tuple[torch.device, ...]:
    """The shards' devices: `devices` as given (a sequence), or one device
    (a str or ``torch.device``) shared by `n` shards, or by default one shard
    a card (`n` shards over the cards, round robin); the default needs CUDA."""
    if devices is None:
        resolve_device("cuda")
        count = torch.cuda.device_count()
        n = count if n is None else n
        return tuple(torch.device("cuda", d % count) for d in range(n))
    if isinstance(devices, (str, torch.device)):
        return (_device(devices),) * (1 if n is None else n)
    return tuple(_device(d) for d in devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D ``("shard",)`` mesh.  `devices` is a sequence of devices (one a
    shard, in order; `n_devices` then takes its first ones), or one device
    that all `n_devices` shards share; by default shard d lies on card
    ``d % device_count``."""
    if devices is not None and not isinstance(devices, (str, torch.device)):
        devices = list(devices)[:n_devices]
    return Mesh(_shard_devices(n_devices, devices))


def make_host_chip_mesh(n_hosts: int, chips_per_host: int, devices=None) -> Mesh:
    """The multi-host shape, ``("host", "chip")``: the same shards, host-major;
    the exchanges also count as DCN bytes (``dist_ops._account_shuffle``)."""
    n = n_hosts * chips_per_host
    if devices is not None and not isinstance(devices, (str, torch.device)):
        devices = list(devices)[:n]
    return Mesh(_shard_devices(n, devices), ("host", "chip"), (n_hosts, chips_per_host))


def mesh_size(mesh: Mesh) -> int:
    """The number of global shards."""
    return mesh.size
