"""Hash- and range-partitioned all-to-all shuffle (port of the JAX package's
``parallel/shuffle.py``).

Each shard packs its live rows into fixed-capacity slots by destination
(``ndev * cap`` rows: cap slots a destination), one all-to-all exchanges
the slots, and each shard compacts what it received.  Capacities are set
by the caller; true counts ride alongside, and rows past a destination's
capacity are counted as overflow, never dropped in silence (callers retry
with a larger capacity, ``dist_ops._run_with_overflow_retry``).

The JAX package packs by a rank per destination (a one-hot cumsum or two
word sorts, ``_dest_ranks``) and a placement sort or a scatter.  Here the
pack is K9 (``kernels/stage_cells``): a stable partition into cells whose
counts (clamped to cap), overflow and zeroed dead slots are exactly
``partition_to_slots``' outputs on both JAX routes.  The exchange is the
mesh's ``all_to_all`` of each column, then K3 (``compact_rows``) brings
the received rows to the front.

The JAX functions run inside ``shard_map`` on one chip's view; these take
the mesh and one value a local shard (lists), and return lists.
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..ops.movement import compact_rows, stage_to_cells, value_boundaries
from .mesh import Mesh, mesh_size

# The JAX package's switch between its two rank engines; both give the same
# ranks, and so does the port's one (K9), whatever the name.
SORT_RANK_MIN_NDEV = 16


def _dest_ranks(dest: torch.Tensor, ndev: int,
                engine: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """(counts int32[ndev + 1], rank int32[n]): each destination's total and
    each row's arrival rank within its destination; dest values (int32) lie
    in [0, ndev].  K9 twice: ``value_boundaries`` for the starts and the
    staging order "si" (rows by destination, then row), whose place less its
    destination's start is the rank."""
    n = dest.shape[0]
    dev = dest.device
    if n == 0:
        return (torch.zeros(ndev + 1, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    if engine == "auto":
        engine = "sort" if ndev + 1 > SORT_RANK_MIN_NDEV else "onehot"
    if engine not in ("onehot", "sort"):
        raise ValueError(f"unknown rank engine {engine!r}")
    starts = value_boundaries(dest, ndev + 2)
    _, _, si, _ = stage_to_cells(dest, None, ndev + 1, 1, [], row_map="si", in_range=True)
    si = si.long()
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[si] = (torch.arange(n, device=dev) - starts[dest[si].long()]).to(torch.int32)
    return starts[1:] - starts[:-1], rank


def partition_to_slots(
    batch: RecordBatch,
    count,
    dest: torch.Tensor,
    ndev: int,
    cap: int,
    cfg: EngineConfig = DEFAULT_CONFIG,
    extra: tuple = (),
) -> tuple[RecordBatch, tuple, torch.Tensor, torch.Tensor]:
    """Pack rows into ``ndev * cap`` send slots grouped by destination.

    Rows at or past `count` and rows beyond a destination's `cap` go
    nowhere; the latter are counted as overflow.  `extra` int32 word columns
    (partial aggregates) ride the same slots.  Returns (send batch, send
    extras, send counts int32[ndev], overflow 0-d int32): one K9 launch over
    every payload word; placed rows keep their own valid bit, dead slots are
    zero (valid False).  `cfg` picks no route here: both JAX routes give this
    result."""
    words = batch.payload_words()
    cells, counts, _, overflow = stage_to_cells(dest, None, ndev, cap, words + list(extra),
                                                row_map="none", count=count)
    nw = len(words)
    return RecordBatch.from_payload_words(cells[:nw]), tuple(cells[nw:]), counts, overflow


def _chunked_all_to_all(mesh: Mesh, xs: list, cap: int, nchunks: int) -> list:
    """``mesh.all_to_all`` of [ndev * cap, ...] slot buffers, as `nchunks`
    exchanges of a ``cap / nchunks`` sub-range of every destination's slots
    (the same result as one exchange)."""
    if nchunks == 1:
        return mesh.all_to_all(xs)
    ndev = mesh_size(mesh)
    rest = tuple(xs[0].shape[1:])
    ccap = -(-cap // nchunks)
    parts = []
    for c in range(nchunks):
        lo, hi = c * ccap, min((c + 1) * ccap, cap)
        if lo >= hi:
            continue
        sl = [x.reshape((ndev, cap) + rest)[:, lo:hi].reshape((-1,) + rest) for x in xs]
        parts.append([y.reshape((ndev, hi - lo) + rest) for y in mesh.all_to_all(sl)])
    return [torch.cat([p[d] for p in parts], 1).reshape(xs[d].shape) for d in range(len(xs))]


def exchange(
    mesh: Mesh,
    sends: list,
    send_counts: list,
    cap: int,
    cfg: EngineConfig = DEFAULT_CONFIG,
    extras: list | None = None,
    nchunks: int = 1,
) -> tuple[list, list, list, list]:
    """all_to_all the slot buffers; compact the received rows to the front.

    ``nchunks`` > 1 exchanges every column as that many copies of a
    ``cap / nchunks`` sub-range of each destination's slots; the result is
    the same.  (In the JAX package XLA may overlap the slices with the
    unpacking; here they run one after another.)

    Returns, a shard each: (received batch [ndev * cap], received extras,
    received total 0-d int32, received counts int32[ndev] by source).
    """
    nchunks = max(1, min(nchunks, cap))
    extras = extras if extras is not None else [()] * len(sends)
    cols = {c: _chunked_all_to_all(mesh, [getattr(s, c) for s in sends], cap, nchunks)
            for c in ("recid", "num", "strw", "valid")}
    nx = len(extras[0])
    rx = [_chunked_all_to_all(mesh, [e[j] for e in extras], cap, nchunks) for j in range(nx)]
    recv_counts = mesh.all_to_all(send_counts)  # rows from each source shard
    outs, out_extras, totals = [], [], []
    for d in range(len(sends)):
        recv = RecordBatch(*(cols[c][d] for c in ("recid", "num", "strw", "valid")))
        slot = torch.arange(cap, dtype=torch.int32, device=recv.recid.device)
        mask = (slot[None, :] < recv_counts[d][:, None]).reshape(-1)
        out, total, out_x = compact_rows(recv, mask, extra=tuple(r[d] for r in rx), cfg=cfg)
        outs.append(out)
        out_extras.append(out_x)
        totals.append(total)
    return outs, out_extras, totals, recv_counts


def shuffle(
    mesh: Mesh,
    batches: list,
    counts: list,
    dests: list,
    cap: int,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[list, list, list]:
    """Full shuffle: partition, all_to_all, compact.

    Returns (received batches [ndev * cap], received counts, overflow summed
    over the shards: any shard's overflow fails the whole step)."""
    outs, _, totals, overflow = shuffle_with_extra(mesh, batches, counts, dests, cap, cfg)
    return outs, totals, overflow


def shuffle_with_extra(
    mesh: Mesh,
    batches: list,
    counts: list,
    dests: list,
    cap: int,
    cfg: EngineConfig = DEFAULT_CONFIG,
    extras: list | None = None,
    nchunks: int = 1,
) -> tuple[list, list, list, list]:
    """Shuffle with rider word columns (partial aggregates, a tuple a shard)
    and an optional chunked exchange.  Returns (received batches, received
    extras, received counts, overflow)."""
    ndev = mesh_size(mesh)
    extras = extras if extras is not None else [()] * len(batches)
    packed = [partition_to_slots(b, c, t, ndev, cap, cfg, extra=x)
              for b, c, t, x in zip(batches, counts, dests, extras)]
    outs, out_extras, totals, _ = exchange(
        mesh, [p[0] for p in packed], [p[2] for p in packed], cap, cfg,
        extras=[p[1] for p in packed], nchunks=nchunks)
    return outs, out_extras, totals, mesh.psum([p[3] for p in packed])
