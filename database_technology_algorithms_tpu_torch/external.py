"""External (out-of-core) operator drivers: bounded device memory, spill files.

Port of the JAX package's ``external.py``, function for function, with the
same outputs and the same ``OperatorStats``.  The reference handles data
far beyond memory by run formation and a multi-pass K-way merge under an
``nmem_blocks`` budget (``DatabaseProject.cpp:172-381``).  Here it is a
two-pass distribution sort:

  pass 1 (run formation): stream ``mem_rows`` chunks, sort each on the card
    (``sort_batch``: K5 and K6, then K4), spill the sorted segment and its
    host key matrix, and keep a sample of the keys;
  pass 2 (distribute): choose splitters from the merged sample so that each
    key range fits the budget; every segment is sorted, so a range is one
    contiguous slice of each (a binary search on the memory-mapped key
    matrix); gather a range's slices, sort them on the card, emit in key
    order.  A range that a splitter missed is split again at its own median.

Spill segments are the resume unit: a JSON manifest records each segment
with a fingerprint of its input chunk, so a re-run skips matching segments
and recomputes anything stale.  The joins stream two key-ordered outputs
of ``external_sort`` through a chunk-pair merge cursor whose membership
test is the in-budget ``hash_join_count`` (K1 or K5, K6, K2, K7).

The key matrices are computed on the host from the columns (``_np_key_words``,
u32 at the full string width), so a segment's keys and a 1-row seam key need
no round trip to the card.  The public drivers take ``device`` (default: the
card).
"""

from __future__ import annotations

import json
import os
import pathlib
import zlib
from typing import Callable, Iterator

import numpy as np

from .batch import (
    FIELD_NUMSTR,
    FIELD_RECID,
    FIELD_STR,
    STR_PAD,
    RecordBatch,
    canonical_field,
    pack_str_bytes,
)
from .config import DEFAULT_CONFIG, EngineConfig
from .metrics import OperatorStats, Timer
from .ops.chunked import _searchsorted_rows
from .ops.distinct import distinct_sorted
from .ops.filter import truncate
from .ops.hash_join import hash_join_count
from .ops.sort import sort_batch
from .utils.checks import resolve_device


def _np_key_words(cols: dict, field) -> np.ndarray:
    """Host (nrows, nwords) uint32 key-word matrix, in the device's word
    order (recid; num; the string's big-endian words; num then the string's).

    The width is pinned to the full string width (32 words), so the key
    matrices of segments and chunks that store different narrow widths
    concatenate and compare alike.  The words are unsigned: ``np.lexsort``
    and the tuple compares of the binary search and the seam rely on that.
    """
    fld = canonical_field(field)
    if fld == FIELD_RECID:
        words = [np.asarray(cols["recid"], np.uint32)[:, None]]
    else:
        words = []
        if fld != FIELD_STR:
            words.append(np.asarray(cols["num"], np.uint32)[:, None])
        if fld in (FIELD_STR, FIELD_NUMSTR):
            strs = np.asarray(cols["strs"], np.uint8)
            full = np.zeros((len(strs), STR_PAD), np.uint8)
            full[:, : min(strs.shape[1], STR_PAD)] = strs[:, :STR_PAD]
            words.append(pack_str_bytes(full))
    return np.ascontiguousarray(np.concatenate(words, axis=1), dtype=np.uint32)


def _chunk_crc(chunk: dict) -> str:
    """Content fingerprint of one input chunk (a host CRC)."""
    h = 0
    for k in ("recid", "num", "strs", "valid"):
        if k in chunk and chunk[k] is not None:
            a = np.ascontiguousarray(np.asarray(chunk[k]))
            h = zlib.crc32(a.tobytes(), h)
    return f"{h:08x}"


class SegmentStore:
    """Spill directory of sorted column segments and a manifest (the resume
    unit).

    Each spilled segment records a fingerprint (sort field, input-chunk CRC,
    row count); resume reuses a segment only when the fingerprint matches
    the chunk being streamed again, so a spill directory holding another
    run's segments (another field, other data, a crashed run's leftovers)
    is recomputed rather than resumed.
    """

    COLS = ("recid", "num", "strs", "valid")

    def __init__(self, spill_dir: str):
        self.dir = pathlib.Path(spill_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.dir / "manifest.json"
        self.manifest = {"segments": [], "segmeta": {}}
        if self.manifest_path.exists():
            self.manifest = json.loads(self.manifest_path.read_text())
            self.manifest.setdefault("segmeta", {})

    def save_manifest(self):
        tmp = self.manifest_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.manifest))
        os.replace(tmp, self.manifest_path)

    def seg_path(self, i: int, name: str) -> pathlib.Path:
        return self.dir / f"segment{i}.{name}.npy"

    def segment_matches(self, i: int, meta: dict) -> bool:
        return (
            i in self.manifest["segments"]
            and self.manifest["segmeta"].get(str(i)) == meta
            # "keys" too: a segment whose key matrix was lost recomputes
            and all(self.seg_path(i, c).exists() for c in self.COLS + ("keys",))
        )

    def write_segment(self, i: int, cols: dict, keys: np.ndarray, meta: dict | None = None) -> int:
        nbytes = 0
        for name, arr in {**cols, "keys": keys}.items():
            np.save(self.seg_path(i, name), arr)
            nbytes += arr.nbytes
        self.manifest["segmeta"][str(i)] = meta or {}
        if i not in self.manifest["segments"]:
            self.manifest["segments"].append(i)
        self.save_manifest()
        return nbytes

    def open_segment(self, i: int) -> tuple[dict, np.ndarray]:
        """Memory-mapped view of a spilled segment: columns and key matrix.
        Nothing is read from disk until sliced, so pass 2 stays out of core
        (the reference's bounded buffer, ``DatabaseProject.cpp:245-369``)."""
        def load(name):
            return np.load(self.seg_path(i, name), mmap_mode="r")

        return {k: load(k) for k in self.COLS}, load("keys")

    def read_segment(self, i: int) -> tuple[dict, np.ndarray]:
        cols, keys = self.open_segment(i)
        return {k: np.array(v) for k, v in cols.items()}, np.array(keys)

    def cleanup(self):
        for f in self.dir.glob("segment*.npy"):
            f.unlink()
        if self.manifest_path.exists():
            self.manifest_path.unlink()


def _to_batch(cols: dict, device) -> RecordBatch:
    return RecordBatch.from_numpy(
        cols["recid"], cols["num"], cols["strs"], cols.get("valid"),
        normalize=False, device=device,
    )


def _distinct_chunk(chunk, field, device) -> dict:
    """DISTINCT of a key-sorted chunk (a batch on the device, or host
    columns), as host columns: K6 in place, then K3 and K4."""
    batch = chunk if isinstance(chunk, RecordBatch) else _to_batch(chunk, device)
    if batch.nrows == 0:
        return batch.to_numpy()
    out, n = distinct_sorted(batch, field)
    return truncate(out, int(n)).to_numpy()


def external_sort(
    chunks: Iterator[dict] | Callable[[], Iterator[dict]],
    field,
    spill_dir: str,
    cfg: EngineConfig = DEFAULT_CONFIG,
    mem_rows: int | None = None,
    stats: OperatorStats | None = None,
    distinct: bool = False,
    device=None,
) -> Iterator[dict]:
    """Sort a host column-chunk stream under a device-memory budget.

    Yields sorted column chunks (each at most mem_rows rows) in global key
    order.  With ``distinct=True`` it also drops duplicate keys globally
    (the external EliminateDuplicates): pass 2's ranges partition by key,
    so all duplicates of a key meet in one device sort, and a key that
    spans chunks (the all-equal path) is cut at the seam.
    """
    stats = stats if stats is not None else OperatorStats(op="external_sort")
    mem_rows = mem_rows or cfg.mem_rows
    dev = resolve_device(device)
    store = SegmentStore(spill_dir)
    t = Timer()

    chunk_iter = chunks() if callable(chunks) else chunks

    # ---- pass 1: run formation -------------------------------------------
    nseg = 0
    samples = []
    total_rows = 0
    sample_every = max(mem_rows // 256, 1)
    for chunk in chunk_iter:
        n = len(chunk["recid"])
        if n > mem_rows:
            raise ValueError(f"external_sort: a chunk of {n} rows exceeds mem_rows={mem_rows}")
        total_rows += n
        meta = {"field": str(field), "crc": _chunk_crc(chunk), "nrows": n}
        if store.segment_matches(nseg, meta):
            cols, keys = store.read_segment(nseg)  # resume: already spilled
        else:
            sorted_b, _ = sort_batch(_to_batch(chunk, dev), field, cfg)
            cols = sorted_b.to_numpy()
            keys = _np_key_words(cols, field)
            stats.bytes_hbm += 2 * sum(v.nbytes for v in cols.values())
            stats.bytes_host += store.write_segment(nseg, cols, keys, meta)
        samples.append(keys[::sample_every])
        nseg += 1

    stats.nsorted_segs = nseg
    stats.rows_in = total_rows

    if nseg == 0:
        stats.npasses = 0
        stats.wall_s = t.stop()
        return
    if nseg == 1:
        # fits in one budgeted chunk: a single pass, streamed straight out
        cols, _ = store.read_segment(0)
        if distinct:
            cols = _distinct_chunk(cols, field, dev)
        stats.npasses = 1
        stats.rows_out = len(cols["recid"])
        stats.wall_s = t.stop()
        yield cols
        store.cleanup()
        return

    # ---- pass 2: sample splitters, gather key ranges ----------------------
    sample = np.concatenate(samples, axis=0)
    sample = sample[np.lexsort(sample.T[::-1])]
    # enough ranges that a perfectly balanced range fits in half the budget
    nranges = max(2 * (total_rows // mem_rows + 1), 2)
    step = max(len(sample) // nranges, 1)
    splitters = sample[step::step]

    # memory-mapped segments: pass 2 reads only each range's slice of each
    # segment (a binary search on the mapped key matrix finds it)
    seg_cols, seg_keys = [], []
    for i in range(nseg):
        cols, keys = store.open_segment(i)
        seg_cols.append(cols)
        seg_keys.append(keys)

    prev_keyvec = None

    def emit(oc):
        """Seam dedup (for distinct) and accounting of one output chunk;
        `oc` is a key-sorted batch on the device or host columns."""
        nonlocal prev_keyvec
        if distinct:
            oc = _distinct_chunk(oc, field, dev)
            if prev_keyvec is not None and len(oc["recid"]):
                first = _np_key_words({k: v[:1] for k, v in oc.items()}, field)[0]
                if tuple(first) == tuple(prev_keyvec):
                    oc = {k: v[1:] for k, v in oc.items()}
        elif isinstance(oc, RecordBatch):
            oc = oc.to_numpy()
        if len(oc["recid"]) == 0:
            return None
        if distinct:
            prev_keyvec = _np_key_words({k: v[-1:] for k, v in oc.items()}, field)[0]
        stats.rows_out += len(oc["recid"])
        return oc

    # ranges as per-segment [lo, hi) windows, worked through in key order;
    # a range beyond the budget (a splitter-sample miss, e.g. a hot key
    # collapsing adjacent splitters) is split again by its own spilled keys,
    # so neither the bounded buffer nor the global order breaks
    def initial_ranges():
        cursors = [0] * nseg
        out = []
        for hi in list(splitters) + [None]:
            slices = []
            for i in range(nseg):
                lo_idx = cursors[i]
                hi_idx = (
                    len(seg_keys[i]) if hi is None
                    else _searchsorted_rows(seg_keys[i], hi, "right")
                )
                slices.append((lo_idx, hi_idx))
                cursors[i] = hi_idx
            out.append(slices)
        return out

    stack = list(reversed(initial_ranges()))
    while stack:
        slices = stack.pop()
        total = sum(hi - lo for lo, hi in slices)
        if total == 0:
            continue
        if total <= mem_rows:
            parts = []
            for i, (lo, hi) in enumerate(slices):
                if hi > lo:
                    part = {k: np.array(v[lo:hi]) for k, v in seg_cols[i].items()}
                    stats.bytes_host += sum(v.nbytes for v in part.values())
                    parts.append(part)
            stats.peak_range_rows = max(stats.peak_range_rows, total)
            merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
            del parts
            sorted_b, _ = sort_batch(_to_batch(merged, dev), field, cfg)
            stats.bytes_hbm += 2 * sum(v.nbytes for v in merged.values())
            oc = emit(sorted_b)
            if oc is not None:
                yield oc
            continue
        # oversized range: all-equal keys cannot be split, but then every
        # row order is key order; stream bounded sub-slices directly
        live = [(i, lo, hi) for i, (lo, hi) in enumerate(slices) if hi > lo]
        lo_key = min(tuple(seg_keys[i][lo]) for i, lo, _ in live)
        hi_key = max(tuple(seg_keys[i][hi - 1]) for i, _, hi in live)
        if lo_key == hi_key:
            for i, lo, hi in live:
                for s in range(lo, hi, mem_rows):
                    e = min(s + mem_rows, hi)
                    sub = {k: np.array(v[s:e]) for k, v in seg_cols[i].items()}
                    stats.bytes_host += sum(v.nbytes for v in sub.values())
                    stats.peak_range_rows = max(stats.peak_range_rows, e - s)
                    oc = emit(sub)  # equal keys: already in key order
                    if oc is not None:
                        yield oc
            continue
        # split again at the range's own median key (sampled from the
        # spilled sorted key matrices; mapped reads only)
        samp = []
        for i, lo, hi in live:
            stride = max((hi - lo) // 64, 1)
            samp.append(np.array(seg_keys[i][lo:hi:stride]))
        sample_r = np.concatenate(samp, axis=0)
        med = sample_r[np.lexsort(sample_r.T[::-1])[len(sample_r) // 2]]
        side = "right" if tuple(med) == lo_key else "left"
        left, right = [], []
        for i, (lo, hi) in enumerate(slices):
            mid = lo + _searchsorted_rows(seg_keys[i][lo:hi], med, side)
            left.append((lo, mid))
            right.append((mid, hi))
        # both halves are strictly smaller: the range holds more than one
        # key, so a split at (or right of) a present key leaves neither empty
        stack.append(right)
        stack.append(left)

    stats.npasses = 2
    stats.wall_s = t.stop()
    store.cleanup()


# ---------------------------------------------------------------------------
# external (bounded-memory) joins
# ---------------------------------------------------------------------------


def _chunk_key_bounds(cols: dict, field) -> tuple[tuple, tuple]:
    """(min_key, max_key) of a key-sorted chunk as comparable tuples."""
    first = tuple(_np_key_words({k: v[:1] for k, v in cols.items()}, field)[0])
    last = tuple(_np_key_words({k: v[-1:] for k, v in cols.items()}, field)[0])
    return first, last


def _stream_semi_join(
    emit_chunks: Iterator[dict],
    member_chunks: Iterator[dict],
    field,
    cfg: EngineConfig,
    cap: int,
    stats: OperatorStats,
    device,
    field3_mult: bool = False,
) -> Iterator[dict]:
    """Merge-cursor semi-join over two KEY-ORDERED host chunk streams.

    Yields, in the emit stream's (global key) order, the emit-stream rows
    whose key appears in the member stream.  Membership ORs across member
    chunks and build multiplicity adds across them (each member row lives
    in one chunk), so per-chunk-pair counts accumulate exactly.  This is
    the bounded-memory heir of the reference's two-pointer merge
    (``DatabaseProject.cpp:406-494``): one chunk of each stream is resident
    and each device call sees at most ``2 * cap`` rows.

    The JAX form pads each side to ``cap`` rows (``_pad_chunk``) so that XLA
    compiles one program per width; torch compiles nothing per shape, so
    each side goes to the card at its own row count, with the same bound.

    ``field3_mult=True`` applies the reference HashJoin's multimap
    semantics on field 3 (``DatabaseProject.cpp:619-628``): ``nres`` sums
    the build multiplicity and each matched emit row is repeated that many
    times.

    Advance rule: after the current pair, the side whose max key is smaller
    cannot match anything later on the other side; it is flushed (emit
    side) or dropped (member side) and its next chunk pulled.  The member
    stream is drained at the end either way, so that its generator
    finishes (stats totals, spill cleanup).
    """
    expand = field3_mult and canonical_field(field) == FIELD_NUMSTR

    def next_nonempty(it):
        # a 0-row chunk (an all-empty-blocks file) has no key bounds
        for c in it:
            if len(c["recid"]):
                return c
        return None

    ea = next_nonempty(emit_chunks)
    mb = next_nonempty(member_chunks)

    # boundary carry: external_sort's chunks never split a key EXCEPT where
    # one key has more duplicates than the budget (the all-equal path).  A
    # member key spanning retired chunks must still hand its whole
    # multiplicity to emit chunks that arrive later, so the member stream's
    # current boundary key carries its count across retirements; a new emit
    # chunk starts with that carry applied (only the boundary key can appear
    # again: every smaller retired key is below the new chunk's minimum)
    carry_key: tuple | None = None
    carry_mult = 0

    def fresh_macc(cols):
        m = np.zeros(len(cols["recid"]), np.int64)
        if carry_key is not None and carry_mult:
            kw = _np_key_words(cols, field)
            eq = np.all(kw == np.asarray(carry_key, dtype=kw.dtype), axis=1)
            m[eq] += carry_mult
        return m

    macc = None if ea is None else fresh_macc(ea)

    def flush(cols, m):
        matched = m > 0
        if expand:
            stats.nres += int(m.sum())
        else:
            stats.nres += int(matched.sum())
        if not matched.any():
            return None
        out = {k: np.asarray(v)[matched] for k, v in cols.items()}
        if expand:
            reps = m[matched]
            out = {k: np.repeat(v, reps, axis=0) for k, v in out.items()}
        stats.rows_out += len(out["recid"])
        return out

    def retire_member(cols):
        nonlocal carry_key, carry_mult
        kw = _np_key_words(cols, field)
        kb = tuple(kw[-1])
        cnt = int(np.all(kw == np.asarray(kb, dtype=kw.dtype), axis=1).sum())
        if carry_key == kb:
            carry_mult += cnt
        else:
            carry_key, carry_mult = kb, cnt

    while ea is not None:
        n_e = len(ea["recid"])
        if mb is None:
            # member stream exhausted: nothing further can match
            out = flush(ea, macc)
            if out is not None:
                yield out
            ea = next_nonempty(emit_chunks)
            macc = None if ea is None else fresh_macc(ea)
            continue
        e_min, e_max = _chunk_key_bounds(ea, field)
        m_min, m_max = _chunk_key_bounds(mb, field)
        if not (e_max < m_min or m_max < e_min):  # disjoint ranges need no device call
            stats.peak_range_rows = max(stats.peak_range_rows, n_e + len(mb["recid"]))
            stats.bytes_hbm += sum(
                int(np.asarray(v).nbytes) for v in (*ea.values(), *mb.values())
            )
            _, mult, _ = hash_join_count(_to_batch(mb, device), _to_batch(ea, device), field, cfg)
            macc += mult.cpu().numpy()
        # flush the emit chunk only once the member stream has moved STRICTLY
        # past it: at e_max == m_max the boundary key's duplicates may go on
        # in the next member chunk (field 3's multiplicity)
        if e_max < m_max:
            out = flush(ea, macc)
            if out is not None:
                yield out
            ea = next_nonempty(emit_chunks)
            macc = None if ea is None else fresh_macc(ea)
        else:
            retire_member(mb)
            mb = next_nonempty(member_chunks)
    # drain the member stream: its generator's trailing code (stats, npasses,
    # spill cleanup) must run even when the emit stream ran out first
    for _ in member_chunks:
        pass


def external_merge_join(
    r_chunks: Iterator[dict] | Callable[[], Iterator[dict]],
    s_chunks: Iterator[dict] | Callable[[], Iterator[dict]],
    field,
    spill_dir: str,
    cfg: EngineConfig = DEFAULT_CONFIG,
    mem_rows: int | None = None,
    stats: OperatorStats | None = None,
    device=None,
) -> Iterator[dict]:
    """External MergeJoin: a bounded-memory sort, distinct and intersection.

    The reference MergeJoin is external end to end: EliminateDuplicates on
    both inputs, then a two-pointer merge of the two sorted distinct files
    through an nmem_blocks-bounded buffer ring, emitting the R record of
    each matched key (``DatabaseProject.cpp:384-502``).  Here both inputs
    run through ``external_sort(distinct=True)`` and meet in the chunk-pair
    merge cursor (:func:`_stream_semi_join`): each side holds one chunk of
    at most mem_rows / 2 rows, so the card never holds more than mem_rows.

    Yields matched R rows in global key order.  Stats: ``nres`` pairs,
    ``nunique_r``/``nunique_s``, ``peak_range_rows`` <= mem_rows.
    """
    stats = stats if stats is not None else OperatorStats(op="external_merge_join")
    mem_rows = mem_rows or cfg.mem_rows
    dev = resolve_device(device)
    cap = max(mem_rows // 2, 1)
    st_r = OperatorStats(op="external_sort_r")
    st_s = OperatorStats(op="external_sort_s")
    r_sorted = external_sort(
        r_chunks, field, os.path.join(spill_dir, "r"), cfg,
        mem_rows=cap, stats=st_r, distinct=True, device=dev,
    )
    s_sorted = external_sort(
        s_chunks, field, os.path.join(spill_dir, "s"), cfg,
        mem_rows=cap, stats=st_s, distinct=True, device=dev,
    )
    t = Timer()
    yield from _stream_semi_join(r_sorted, s_sorted, field, cfg, cap, stats, dev)
    stats.nunique = st_r.rows_out
    stats.nunique_r = st_r.rows_out
    stats.nunique_s = st_s.rows_out
    stats.nsorted_segs = st_r.nsorted_segs + st_s.nsorted_segs
    stats.npasses = max(st_r.npasses, st_s.npasses) + 1
    stats.rows_in = st_r.rows_in + st_s.rows_in
    stats.bytes_host += st_r.bytes_host + st_s.bytes_host
    stats.wall_s = t.stop()


def external_hash_join(
    build_chunks: Iterator[dict] | Callable[[], Iterator[dict]],
    probe_chunks: Iterator[dict] | Callable[[], Iterator[dict]],
    field,
    spill_dir: str,
    cfg: EngineConfig = DEFAULT_CONFIG,
    mem_rows: int | None = None,
    stats: OperatorStats | None = None,
    device=None,
) -> Iterator[dict]:
    """External HashJoin: a bounded-memory semi-join emitting probe rows.

    Reference semantics field for field: fields 0-2 collapse the build side
    to a key set (it streams as ``external_sort(distinct=True)``); field 3
    keeps the multimap multiplicity (``DatabaseProject.cpp:619-628``): the
    build stream stays merely sorted, per-chunk multiplicities add up, and
    each matched probe row is emitted once per matching build record.  The
    probe side is sorted with its duplicates kept, and matched probe rows
    stream out in probe KEY order (the in-budget route emits scan order).
    The same residency as :func:`external_merge_join`.
    """
    fld = canonical_field(field)
    stats = stats if stats is not None else OperatorStats(op="external_hash_join")
    mem_rows = mem_rows or cfg.mem_rows
    dev = resolve_device(device)
    cap = max(mem_rows // 2, 1)
    st_b = OperatorStats(op="external_sort_build")
    st_p = OperatorStats(op="external_sort_probe")
    b_sorted = external_sort(
        build_chunks, field, os.path.join(spill_dir, "b"), cfg,
        mem_rows=cap, stats=st_b, distinct=(fld != FIELD_NUMSTR), device=dev,
    )
    p_sorted = external_sort(
        probe_chunks, field, os.path.join(spill_dir, "p"), cfg,
        mem_rows=cap, stats=st_p, distinct=False, device=dev,
    )
    t = Timer()
    yield from _stream_semi_join(
        p_sorted, b_sorted, field, cfg, cap, stats, dev, field3_mult=True
    )
    stats.nsorted_segs = st_b.nsorted_segs + st_p.nsorted_segs
    stats.npasses = max(st_b.npasses, st_p.npasses) + 1
    stats.rows_in = st_b.rows_in + st_p.rows_in
    stats.bytes_host += st_b.bytes_host + st_p.bytes_host
    stats.wall_s = t.stop()


def blockfile_chunks(path: str, mem_rows: int) -> Iterator[dict]:
    """Stream a reference block file as host column chunks of at most
    mem_rows rows, without loading the whole file."""
    from .io.blockfile import BLOCK_SIZE, MAX_RECORDS_PER_BLOCK, decode_blocks_span

    raw = np.memmap(path, dtype=np.uint8, mode="r")
    nblocks = len(raw) // BLOCK_SIZE
    blocks_per_chunk = max(mem_rows // MAX_RECORDS_PER_BLOCK, 1)
    for b0 in range(0, nblocks, blocks_per_chunk):
        b1 = min(b0 + blocks_per_chunk, nblocks)
        chunk = decode_blocks_span(np.array(raw[b0 * BLOCK_SIZE: b1 * BLOCK_SIZE]))
        # a budget below one block's rows is honoured too: the decoded span
        # is sliced to at most mem_rows rows a chunk
        for s in range(0, len(chunk["recid"]), mem_rows):
            yield {k: v[s: s + mem_rows] for k, v in chunk.items()}
