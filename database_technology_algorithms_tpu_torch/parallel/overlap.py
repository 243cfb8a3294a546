"""The chunked, key-only distributed hash join (port of the JAX package's
``parallel/overlap.py``).

The barrier join (``dist_ops.dist_hash_join``) ships whole records both
ways.  This variant moves only keys:

  1. build keys hash-partition to their owner shard (an all-to-all of u32
     words), where they become one sorted key array;
  2. probe keys are packed into per-destination slots, then exchanged in
     ``nchunks`` slices; each slice's membership probe needs nothing of the
     next;
  3. each slice's match counts return to the probe rows' source shard (the
     tiled all-to-all sends block s back to shard s);
  4. matched probe rows are emitted where they are: the record never
     crosses the mesh.

Keys that are a short u32 word list qualify: fields 0 and 1 (one word), and
fields 2 and 3 where both sides store 2 string words (the stored prefix is
the whole NUL-normalized string).  Output rows stay on their source shard,
a multiset equal to the barrier join's.

In the JAX package XLA may overlap one slice's exchange with another's
probe; in this process the slices run one after another.  Device work: the
key-only pack is K9 with a 0xFFFFFFFF fill; the build keys' sort K5; the
one-word probe K15 (``sorted_probe``, the JAX searchsorted and take), the
multi-word one K10 (``member_multiplicity``).
"""

from __future__ import annotations

import torch

from ..batch import canonical_field
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.sorted_probe import sorted_probe
from ..ops.filter import compact
from ..ops.hash_join import member_multiplicity
from ..ops.movement import sort_words, stage_to_cells
from .dist_ops import DistTable, _run_with_overflow_retry, _shuffle_cap, hash_dest
from .mesh import Mesh, mesh_size

U32_MAX = -1  # 0xFFFFFFFF as int32 bits


def overlap_key_words(batch, field) -> list | None:
    """The full key as a short u32 word list, or None if it is not one: the
    stored string words are the whole string only at a stored width of 2."""
    f = canonical_field(field)
    if f == 0:
        return [batch.recid]
    if f == 1:
        return [batch.num]
    if batch.str_words != 2:
        return None
    sw = [batch.strw[:, 0], batch.strw[:, 1]]
    return sw if f == 2 else [batch.num] + sw


def _partition_words_to_slots(
    words: list, count, dest: torch.Tensor, ndev: int, cap: int
) -> tuple[list, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slot-pack a short key-word list by destination.

    Returns (slots: a [ndev * cap] array a word with 0xFFFFFFFF in the dead
    slots, the slot of each row (ndev * cap for rows past `count` or
    beyond capacity), send counts int32[ndev], overflow): one K9 launch."""
    slots, counts, slot_of_row, overflow = stage_to_cells(
        dest, None, ndev, cap, words, row_map="slots", count=count, fill=U32_MAX)
    return slots, slot_of_row, counts, overflow


def _probe(bkeys: list, n_bkeys, keys: list, live: torch.Tensor) -> torch.Tensor:
    """int32 per query key: the number of live build keys equal to it (one
    word: K15, 0 or 1; more: K10), 0 for a dead query row."""
    if len(bkeys) == 1:
        hit, _ = sorted_probe(bkeys[0], n_bkeys, keys[0])
        return (hit & live).to(torch.int32)
    return member_multiplicity(bkeys, n_bkeys, keys, live)


def _sorted_build_keys(words: list, live: torch.Tensor, n_live) -> list:
    """The live keys sorted to the front (K5 over (dead, words)), the rest
    0xFFFFFFFF."""
    srt, _ = sort_words([~live] + list(words))
    pos = torch.arange(live.shape[0], device=live.device)
    return [torch.where(pos < n_live, w, U32_MAX) for w in srt[1:]]


def _emit(mesh: Mesh, pb: list, mult: list, field, cfg: EngineConfig) -> tuple[list, list, list]:
    """Compact the matched probe rows where they are; nres counts the matched
    rows for fields 0-2 and sums the build multiplicity for field 3."""
    outs, cnts, sums = [], [], []
    for p, m in zip(pb, mult):
        out, n_rows = compact(p, m > 0, cfg)
        outs.append(out)
        cnts.append(n_rows)
        sums.append(m.sum(dtype=torch.int32) if canonical_field(field) == 3 else n_rows)
    return outs, cnts, mesh.psum(sums)


def _overlapped_join_colocated(mesh: Mesh, bb: list, bc: list, pb: list, pc: list, field,
                               cfg: EngineConfig, nw_b: list, nw_p: list, nchunks: int):
    """Colocated inputs: the same chunked membership probe against the local
    build keys, and no exchange (each would be an identity)."""
    nchunks = max(nchunks, 1)
    mult = []
    for b, c, p, n_live, kb, kp in zip(bb, bc, pb, pc, nw_b, nw_p):
        dev = c.device
        bkeys = _sorted_build_keys(kb, torch.arange(b.nrows, device=dev) < c, c)
        npr = p.nrows
        chunk = -(-npr // nchunks)
        m = chunk * nchunks
        pw = [torch.cat([w, torch.full((m - npr,), U32_MAX, dtype=w.dtype, device=dev)])
              for w in kp]
        live_all = torch.arange(m, device=dev) < n_live
        parts = [_probe(bkeys, c, [w[i * chunk:(i + 1) * chunk] for w in pw],
                        live_all[i * chunk:(i + 1) * chunk]) for i in range(nchunks)]
        mult.append(torch.cat(parts)[:npr])
    outs, cnts, nres = _emit(mesh, pb, mult, field, cfg)
    return outs, cnts, nres, [torch.zeros((), dtype=torch.int32, device=d) for d in mesh.devices]


def overlapped_join_local(
    mesh: Mesh,
    bb: list,
    bc: list,
    pb: list,
    pc: list,
    field,
    cfg: EngineConfig,
    cap_b: int,
    cap_p: int,
    chunk_cap: int,
    nchunks: int,
    colocated: bool = False,
):
    """The key-only semi-join over the shards (the JAX package's per-chip
    body, split at its collectives).

    Exposed for composed plans (``models/pipeline.make_dist_pipeline`` with
    ``dist_join_engine="overlap"``); ``dist_hash_join_overlapped`` is the
    standalone wrapper.  Returns (probe_out, cnt, nres, overflow), a value a
    shard each (the last two the same on every shard).

    ``colocated=True`` declares the inputs already hash-partitioned by key:
    the three exchanges would send every element to its own shard and are
    skipped, as is the slot sizing.
    """
    ndev = mesh_size(mesh)
    nw_b = [overlap_key_words(b, field) for b in bb]
    nw_p = [overlap_key_words(b, field) for b in pb]
    if nw_b[0] is None or nw_p[0] is None or len(nw_b[0]) != len(nw_p[0]):
        raise AssertionError("overlapped join needs short-word keys on both sides; "
                             "use dist_hash_join for wide strings")
    nw = len(nw_b[0])
    if colocated:
        return _overlapped_join_colocated(mesh, bb, bc, pb, pc, field, cfg, nw_b, nw_p, nchunks)

    # ---- build: a key-only shuffle, one sorted key array a shard ------------
    bpack = [_partition_words_to_slots(w, c, hash_dest(b, field, ndev), ndev, cap_b)
             for w, c, b in zip(nw_b, bc, bb)]
    bkey_recv = [mesh.all_to_all([p[0][j] for p in bpack]) for j in range(nw)]
    brc = mesh.all_to_all([p[2] for p in bpack])
    bkeys, n_bkeys = [], []
    for d in range(len(bb)):
        slot = torch.arange(cap_b, device=brc[d].device)
        live = (slot[None, :] < brc[d][:, None]).reshape(-1)
        n = live.sum(dtype=torch.int32)
        bkeys.append(_sorted_build_keys([k[d] for k in bkey_recv], live, n))
        n_bkeys.append(n)

    # ---- probe: the key slots once, then exchange, probe and return the
    # counts in nchunks slices
    ppack = [_partition_words_to_slots(w, c, hash_dest(b, field, ndev), ndev, cap_p)
             for w, c, b in zip(nw_p, pc, pb)]
    prc = mesh.all_to_all([p[2] for p in ppack])
    back = []  # per slice, a shard's counts in its own slot layout
    for c in range(nchunks):
        lo = c * chunk_cap
        k_recv = [mesh.all_to_all([p[0][j].reshape(ndev, cap_p)[:, lo:lo + chunk_cap]
                                   .reshape(-1) for p in ppack]) for j in range(nw)]
        cnts = []
        for d in range(len(pb)):
            within = torch.arange(lo, lo + chunk_cap, device=prc[d].device)
            live = (within[None, :] < prc[d][:, None]).reshape(-1)
            cnts.append(_probe(bkeys[d], n_bkeys[d], [k[d] for k in k_recv], live))
        back.append(mesh.all_to_all(cnts))  # block s returns to source shard s

    mult = []
    for d in range(len(pb)):
        # [ndev, cap_p] in slot order: slice c fills columns [c * chunk_cap, ...)
        slots = torch.stack([b[d].reshape(ndev, chunk_cap) for b in back], 1).reshape(-1)
        flat = torch.cat([slots, slots.new_zeros(1)])
        # each row knows its slot; a dropped row's is ndev * cap_p, whose count is 0
        mult.append(flat[ppack[d][1].clamp(max=ndev * cap_p).long()])
    outs, cnts, nres = _emit(mesh, pb, mult, field, cfg)
    ovf = mesh.psum([b[3] + p[3] for b, p in zip(bpack, ppack)])
    return outs, cnts, nres, ovf


def dist_hash_join_overlapped(
    mesh: Mesh,
    build: DistTable,
    probe: DistTable,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
    nchunks: int = 4,
    stats=None,
) -> tuple[DistTable, torch.Tensor, torch.Tensor]:
    """The chunked key-only distributed semi-join (u32 fields, or string
    fields at a stored width of 2).  Returns (probe_out, nres, overflow);
    output rows stay on their source shard (a multiset equal to
    ``dist_hash_join``'s)."""
    field = canonical_field(field)
    kb = overlap_key_words(build.batches[0], field)
    kp = overlap_key_words(probe.batches[0], field)
    if kb is None or kp is None or len(kb) != len(kp):
        raise AssertionError("overlapped join needs short-word keys on both sides (u32 fields, "
                             "or string fields at narrow stored width); use dist_hash_join")
    ndev = mesh_size(mesh)
    per_b, per_p = build.rows_per_chip, probe.rows_per_chip

    def run(cap_scale):
        cap_b = min(_shuffle_cap(per_b, ndev, cfg) * cap_scale, max(per_b, 1))
        cap_p0 = min(_shuffle_cap(per_p, ndev, cfg) * cap_scale, max(per_p, 1))
        chunk_cap = -(-cap_p0 // nchunks)
        out, cnt, nres, ovf = overlapped_join_local(
            mesh, build.batches, build.counts, probe.batches, probe.counts, field, cfg,
            cap_b, chunk_cap * nchunks, chunk_cap, nchunks)
        return (out, cnt, nres[0]), ovf[0]

    (out, counts, nres), ovf = _run_with_overflow_retry(
        run, 1, max(per_b, per_p), max_retries=6, stats=stats)
    if stats is not None:
        # key-only traffic: len(kb) u32 words a key each way, and one count
        # word a probe key back
        nw = len(kb)
        b = (per_b * nw + per_p * nw + per_p) * ndev * 4
        stats.rows_in += (per_b + per_p) * ndev
        stats.nres = int(nres)
        stats.bytes_ici += b
        if "host" in mesh.axis_names:
            stats.bytes_dcn += b
    return DistTable(out, counts), nres, ovf
