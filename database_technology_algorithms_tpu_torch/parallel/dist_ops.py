"""Distributed operators: the single-device operators composed with the
shuffle (port of the JAX package's ``parallel/dist_ops.py``).

Semantics: every distributed operator returns the same row multisets and
counters as its single-device form.  The composition is always
*partition, then the local operator*:

  distinct / hash join / aggregate: hash-partition by key (every row of a
      key lands on one shard), then the unchanged local operator;
  sort: a sample-based range partition (shard k holds key range k), then a
      local sort, so the shards in mesh order are the sorted table.

A table is a :class:`DistTable`: one ``RecordBatch`` a shard, each of
``rows_per_chip`` rows, and each shard's live count.  The JAX package's
``shard_map`` bodies are functions over the list of shards here, split at
their collectives (``mesh.all_to_all``, ``all_gather``, ``psum``).

Device work beyond the local operators: the shuffle's pack (K9), its
compaction (K3) and the range destination of the sort (K22); the splitter
sample sorts by K5.  A destination is ``key_hash % ndev`` on the hash's u32
value (:func:`hash_dest`): the port holds the hash as int32 bits, and
torch's ``%`` of a negative int32 takes the divisor's sign.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..batch import RecordBatch, as_u32, u32_to_torch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.range_dest import lex_ge, range_dest
from ..ops.aggregate import group_aggregate_impl as local_group_aggregate
from ..ops.distinct import distinct_impl as local_distinct
from ..ops.filter import compact
from ..ops.hash_join import hash_join_count_impl as local_hash_join_count
from ..ops.keys import key_hash, key_words
from ..ops.movement import sort_words
from ..ops.sort import sort_batch_impl as local_sort_batch
from .mesh import Mesh, mesh_size
from .shuffle import shuffle


@dataclasses.dataclass
class DistTable:
    """A row-split table: one batch a local shard (all of ``rows_per_chip``
    rows and one string width) and each shard's live count (0-d int32 on
    its device)."""

    batches: list
    counts: list

    @property
    def rows_per_chip(self) -> int:
        return self.batches[0].nrows

    def global_batch(self) -> RecordBatch:
        """The shards' rows in mesh order, as one batch on the first shard's
        device: the JAX package's global array (of this process's shards)."""
        dev = self.batches[0].recid.device
        return RecordBatch.concat([
            RecordBatch(*(getattr(b, c).to(dev) for c in ("recid", "num", "strw", "valid")))
            for b in self.batches])

    def global_count(self) -> torch.Tensor:
        """int32[ndev]: the live counts in mesh order, on the first shard's device."""
        dev = self.counts[0].device
        return torch.stack([c.to(dev) for c in self.counts])


def hash_dest(batch: RecordBatch, field, ndev: int) -> torch.Tensor:
    """int32[N]: each row's shard, ``key_hash % ndev`` on the u32 value."""
    return (as_u32(key_hash(batch, field)) % ndev).to(torch.int32)


def distribute(mesh: Mesh, cols: dict, rows_per_chip: int | None = None) -> DistTable:
    """Spread host columns over the shards in contiguous blocks
    (``multihost.pad_columns``): this process's shards' blocks, each on its
    shard's device (every process passes the same columns)."""
    from .multihost import pad_columns

    ndev = mesh_size(mesh)
    n = len(cols["recid"])
    per = rows_per_chip or -(-n // ndev)
    padded, counts = pad_columns(cols, ndev, per)
    batches, live = [], []
    for d, dev in zip(mesh.local_shards, mesh.devices):
        rows = slice(d * per, (d + 1) * per)
        batches.append(RecordBatch(
            recid=u32_to_torch(padded["recid"][rows], dev),
            num=u32_to_torch(padded["num"][rows], dev),
            strw=u32_to_torch(padded["strw"][rows], dev),
            valid=torch.from_numpy(padded["valid"][rows].copy()).to(dev)))
        live.append(torch.tensor(int(counts[d]), dtype=torch.int32, device=dev))
    return DistTable(batches=batches, counts=live)


def collect(table: DistTable) -> dict:
    """The live rows of every local shard, in mesh order, as host columns."""
    parts = [b.slice(0, int(c)).to_numpy() for b, c in zip(table.batches, table.counts)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _shuffle_cap(per_chip_rows: int, ndev: int, cfg: EngineConfig) -> int:
    """Per-destination slot capacity for one shard's sends: a generous floor,
    bounded by the shard's own rows (it cannot send more than it has)."""
    cap = max(int(per_chip_rows * cfg.shuffle_slack) // ndev + 1, 64)
    return min(cap, max(per_chip_rows, 1))


def row_bytes(batch: RecordBatch) -> int:
    """Device row footprint at the batch's stored width:
    recid(4) + num(4) + strw(4K) + valid(1)."""
    return 9 + 4 * batch.str_words


def _account_shuffle(stats, mesh: Mesh, rows: int, nbytes_row: int = 137) -> None:
    """Record exchange traffic: every row crosses the shard boundary once a
    shuffle (the full all-to-all payload is counted); a ``host`` axis
    counts the same bytes as DCN too."""
    if stats is None:
        return
    b = int(rows) * nbytes_row
    stats.bytes_ici += b
    if "host" in mesh.axis_names:
        stats.bytes_dcn += b


def _run_with_overflow_retry(build_and_run, cap: int, cap_limit: int,
                             max_retries: int = 3, stats=None):
    """Call ``build_and_run(cap)``; on shuffle overflow, double cap and retry
    (one host read of the overflow an attempt).  Results of an overflowing
    attempt are discarded.  cap is clamped to cap_limit; returns the first
    attempt without overflow, or the last one's result and overflow."""
    out, ovf = None, None
    for _ in range(max_retries + 1):
        out, ovf = build_and_run(min(cap, cap_limit))
        if int(ovf) == 0 or cap >= cap_limit:
            break
        cap *= 2
        if stats is not None:
            stats.retries += 1
    return out, ovf


# ---------------------------------------------------------------------------
# hash-partitioned operators


def dist_distinct(mesh: Mesh, table: DistTable, field, cfg: EngineConfig = DEFAULT_CONFIG,
                  stats=None) -> tuple[DistTable, torch.Tensor, torch.Tensor]:
    """Distributed EliminateDuplicates.  Returns (table, nunique, overflow)."""
    ndev = mesh_size(mesh)
    per = table.rows_per_chip
    dests = [hash_dest(b, field, ndev) for b in table.batches]

    def run(cap):
        recv, total, ovf = shuffle(mesh, table.batches, table.counts, dests, cap, cfg)
        local = [local_distinct(r, field, cfg, count=t) for r, t in zip(recv, total)]
        return ([o for o, _ in local], [n for _, n in local]), ovf[0]

    (out, counts), ovf = _run_with_overflow_retry(
        run, _shuffle_cap(per, ndev, cfg), per, stats=stats)
    nunique = mesh.psum(counts)[0]
    if stats is not None:
        stats.rows_in += per * ndev
        stats.nunique = int(nunique)
        _account_shuffle(stats, mesh, per * ndev, row_bytes(table.batches[0]))
    return DistTable(out, counts), nunique, ovf


def dist_hash_join(mesh: Mesh, build: DistTable, probe: DistTable, field,
                   cfg: EngineConfig = DEFAULT_CONFIG,
                   stats=None) -> tuple[DistTable, torch.Tensor, torch.Tensor]:
    """Distributed semi-join (the reference HashJoin: fields 0-2 emit the
    matched probe rows, field 3 folds the build multiplicity into nres).
    Returns (probe_out, nres, overflow); rows stay on the key's shard."""
    ndev = mesh_size(mesh)
    per_b, per_p = build.rows_per_chip, probe.rows_per_chip
    bdests = [hash_dest(b, field, ndev) for b in build.batches]
    pdests = [hash_dest(b, field, ndev) for b in probe.batches]

    def run(cap_scale):
        cap_b = min(_shuffle_cap(per_b, ndev, cfg) * cap_scale, max(per_b, 1))
        cap_p = min(_shuffle_cap(per_p, ndev, cfg) * cap_scale, max(per_p, 1))
        brecv, btotal, ovf1 = shuffle(mesh, build.batches, build.counts, bdests, cap_b, cfg)
        precv, ptotal, ovf2 = shuffle(mesh, probe.batches, probe.counts, pdests, cap_p, cfg)
        outs, counts, sums = [], [], []
        for br, bt, pr, pt in zip(brecv, btotal, precv, ptotal):
            matched, mult, _ = local_hash_join_count(br, pr, field, cfg, build_count=bt,
                                                     probe_count=pt)
            out, nres_rows = compact(pr, matched, cfg)
            outs.append(out)
            counts.append(nres_rows)
            sums.append(mult.sum(dtype=torch.int32))
        nres = mesh.psum(sums)[0]
        return (outs, counts, nres), ovf1[0] + ovf2[0]

    (out, counts, nres), ovf = _run_with_overflow_retry(
        run, 1, max(per_b, per_p), max_retries=6, stats=stats)
    if stats is not None:
        stats.rows_in += (per_b + per_p) * ndev
        stats.nres = int(nres)
        _account_shuffle(stats, mesh, per_b * ndev, row_bytes(build.batches[0]))
        _account_shuffle(stats, mesh, per_p * ndev, row_bytes(probe.batches[0]))
    return DistTable(out, counts), nres, ovf


def dist_aggregate(mesh: Mesh, table: DistTable, field, cfg: EngineConfig = DEFAULT_CONFIG,
                   stats=None) -> tuple[DistTable, list, torch.Tensor]:
    """Distributed group-by aggregate.  Returns (representatives, the
    aggregates of each shard's groups (a dict of count, sum, min and max
    columns a shard), overflow)."""
    ndev = mesh_size(mesh)
    per = table.rows_per_chip
    dests = [hash_dest(b, field, ndev) for b in table.batches]

    def run(cap):
        recv, total, ovf = shuffle(mesh, table.batches, table.counts, dests, cap, cfg)
        local = [local_group_aggregate(r, field, cfg, count=t) for r, t in zip(recv, total)]
        return ([r for r, _, _ in local], [n for _, _, n in local],
                [a for _, a, _ in local]), ovf[0]

    (reps, counts, aggs), ovf = _run_with_overflow_retry(
        run, _shuffle_cap(per, ndev, cfg), per, stats=stats)
    if stats is not None:
        stats.rows_in += per * ndev
        _account_shuffle(stats, mesh, per * ndev, row_bytes(table.batches[0]))
    return DistTable(reps, counts), aggs, ovf


# ---------------------------------------------------------------------------
# range-partitioned sort


_lex_ge = lex_ge  # bool[N, S]: key >= splitter (K22 counts it without the matrix)


def dist_sort(mesh: Mesh, table: DistTable, field, cfg: EngineConfig = DEFAULT_CONFIG,
              sample_per_chip: int = 256, stats=None) -> tuple[DistTable, torch.Tensor]:
    """Distributed total-order sort: shard k ends up holding global key range
    k, locally sorted, so the shards in mesh order are the sorted table.

    Each shard samples its live rows (strided; dead samples are the largest
    key, 0xFFFFFFFF words), the samples are all-gathered and sorted (K5) the
    same way on every shard, and ndev - 1 evenly spaced picks are the
    splitters.  A row's destination is the number of splitters its key
    reaches (K22), on the key's leading words (strings: the configured
    prefix), so equal keys share a shard; the local sorts are exact."""
    ndev = mesh_size(mesh)
    per = table.rows_per_chip
    npart_words = 1 if field in (0, 1, "0", "1") else min(cfg.str_prefix_words, 3) + (
        1 if field in (3, "3") else 0)
    stride = max(per // sample_per_chip, 1)
    words = [key_words(b, field, nwords=npart_words)[:npart_words] for b in table.batches]
    samples = []
    for w, b, c in zip(words, table.batches, table.counts):
        idx = torch.arange(b.nrows, device=b.recid.device)[::stride][:sample_per_chip]
        live = idx < c
        samples.append([torch.where(live, x[idx], -1) for x in w])
    nw = len(words[0])
    gathered = [mesh.all_gather([s[j] for s in samples]) for j in range(nw)]
    dests = []
    for d, w in enumerate(words):
        srt, _ = sort_words([g[d] for g in gathered])
        m = srt[0].shape[0]
        picks = (torch.arange(1, ndev, device=srt[0].device) * m) // ndev
        dests.append(range_dest(w, [x[picks] for x in srt]))

    def run(cap):
        recv, total, ovf = shuffle(mesh, table.batches, table.counts, dests, cap, cfg)
        return ([local_sort_batch(r, field, cfg, count=t)[0] for r, t in zip(recv, total)],
                total), ovf[0]

    (out, counts), ovf = _run_with_overflow_retry(
        run, _shuffle_cap(per, ndev, cfg), per, stats=stats)
    if stats is not None:
        stats.rows_in += per * ndev
        _account_shuffle(stats, mesh, per * ndev, row_bytes(table.batches[0]))
    return DistTable(out, counts), ovf
