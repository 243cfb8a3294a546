"""The shard mesh (port of the JAX package's ``parallel/mesh.py``).

The engine's only parallel axis is data partitioning: tables are split by
row across shards, and every distributed operator returns the same row
multisets and counters as its single-device form.  In the JAX package a
mesh is a grid of devices and a table a global array sharded over it; the
per-chip code runs inside ``shard_map`` and calls XLA collectives.

Here a :class:`Mesh` is an ordered list of shards, each with a
``torch.device``.  Devices may repeat: four shards on the one card of a
machine, or eight on the CPU, are a mesh like four cards.  The per-shard
code is a function over the list of shards, split at its collectives, and
the mesh offers the three collectives the operators use, each taking and
returning one tensor a shard:

    all_to_all  tiled: block d of shard s goes to block s of shard d
    all_gather  tiled: every shard gets the shards' tensors concatenated
    psum        every shard gets the sum

In this process each is a set of copies onto the shards' devices (peer
copies between cards, none on one device).  A backend over
``torch.distributed`` with one process a card carries the same three
collectives; nothing above this module depends on which one runs.

The axis names and shape are JAX's: ``("shard",)``, or ``("host", "chip")``
from :func:`make_host_chip_mesh`; they feed the ``bytes_dcn`` accounting
only.  ``row_sharding`` and ``replicated`` have no counterpart: a shard's
rows are its own ``RecordBatch`` (``dist_ops.DistTable``), and a replicated
value is the list of one copy a shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..utils.checks import resolve_device

SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards in mesh order, with JAX's axis names and sizes (their product
    is the number of shards, host-major on a 2-D mesh)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (SHARD_AXIS,)
    axis_sizes: tuple[int, ...] = ()

    def __post_init__(self):
        if not self.axis_sizes:
            object.__setattr__(self, "axis_sizes", (len(self.devices),))
        if math.prod(self.axis_sizes) != len(self.devices) or not self.devices:
            raise ValueError(f"mesh of {len(self.devices)} shards with axes "
                             f"{dict(zip(self.axis_names, self.axis_sizes))}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def _check(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        xs = list(xs)
        if len(xs) != len(self.devices):
            raise ValueError(f"a collective takes one tensor a shard: {len(xs)} for "
                             f"{len(self.devices)} shards")
        return xs

    def all_to_all(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Tiled all-to-all over dim 0: each shard's tensor is ndev equal
        blocks, and block d of shard s becomes block s of shard d."""
        xs = self._check(xs)
        n = len(xs)
        rows = xs[0].shape[0]
        if rows % n:
            raise ValueError(f"all_to_all: {rows} rows do not split into {n} blocks")
        b = rows // n
        return [torch.cat([x[d * b:(d + 1) * b].to(dev) for x in xs])
                for d, dev in enumerate(self.devices)]

    def all_gather(self, xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Tiled all-gather over dim 0: every shard gets the shards' tensors
        concatenated in mesh order (one copy a device, shared by its
        shards; collective results are read, never written)."""
        xs = self._check(xs)
        made: dict = {}
        for dev in self.devices:
            if dev not in made:
                made[dev] = torch.cat([x.to(dev) for x in xs])
        return [made[dev] for dev in self.devices]

    def per_device(self, fn, *xs: Sequence) -> list:
        """fn once for each device and arguments (each of `xs` a value a
        shard): shards of one device that pass the very same objects, as a
        collective's results are, share one result (read, never written);
        a shard whose arguments differ gets its own call."""
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
        total = torch.stack([x.to(dev0) for x in xs]).sum(0, dtype=xs[0].dtype)
        made = {dev0: total}
        for dev in self.devices:
            if dev not in made:
                made[dev] = total.to(dev)
        return [made[dev] for dev in self.devices]


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
    return len(mesh.devices)
