"""Heavy-hitter (skew) handling for the distributed hash join (port of the
JAX package's ``parallel/skew.py``).

BASELINE config 4: a Zipf-keyed join melts a pure hash partition, since
every probe row of a hot key lands on one shard.  Semi-join semantics (the
build side is a key set) allow a split:

1. detect: each shard's top-k key hashes by run count, all-gathered; a hash
   is hot if its summed count exceeds rows / (ndev * hh_factor).  Any
   globally hot key is locally hot somewhere, so the union of the local
   top-k lists holds every heavy hitter.  Both sides are checked.
2. route by hash on both sides: hot build rows are deduplicated locally,
   compacted and all-gathered (replicated: they are few keys); hot probe
   rows stay local and probe the replicated set.  Cold rows take the plain
   hash-partition shuffle.  A cold key whose hash equals a hot hash rides
   the broadcast path on both sides, which stays exact: membership compares
   full keys.

Fields 0-2 (a set-semantics build).  Device work: K5 sorts each shard's
masked hashes and K19 takes their top k; K20 reduces the gathered
candidates to the hot list; K21 tests each row's hash against it; the
local operators (compaction, distinct, the hash join) and the shuffle run
their own kernels.
"""

from __future__ import annotations

import torch

from ..batch import RecordBatch
from ..config import DEFAULT_CONFIG, EngineConfig
from ..kernels.hot_set import SENTINEL, hot_hashes, in_hot_set
from ..kernels.topk_runs import topk_runs
from ..ops.distinct import distinct_impl
from ..ops.filter import compact
from ..ops.hash_join import hash_join_count_impl
from ..ops.keys import key_hash
from ..ops.movement import sort_words
from .dist_ops import DistTable, _shuffle_cap, hash_dest
from .mesh import Mesh, mesh_size
from .shuffle import shuffle


def local_topk_hashes(hashes: torch.Tensor, active: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (hash, count) among the active rows: the masked hashes sorted
    (K5; inactive rows as 0xFFFFFFFF), then their k longest runs (K19) in
    ``lax.top_k``'s order.  k is clamped to the row count."""
    n = hashes.shape[0]
    k = min(k, n)
    if k == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=hashes.device)
        return empty, empty
    (hs,), _ = sort_words([torch.where(active, hashes, SENTINEL)])
    return topk_runs(hs, active.sum(dtype=torch.int32), k)


def hot_hash_set(mesh: Mesh, hashes: list, active: list, k: int, threshold: list) -> list:
    """The global hot-hash list (ndev * k entries, padded with 0xFFFFFFFF),
    a copy a shard: every shard reduces the same all-gathered candidates."""
    local = [local_topk_hashes(h, a, k) for h, a in zip(hashes, active)]
    gh = mesh.all_gather([h for h, _ in local])
    gc = mesh.all_gather([c for _, c in local])
    return [hot_hashes(h, c, t) for h, c, t in zip(gh, gc, threshold)]


in_hash_set = in_hot_set  # bool[N]: the row's hash is in the hot list (K21)


def skew_join_local(
    mesh: Mesh,
    bb: list,
    bc: list,
    pb: list,
    pc: list,
    field,
    cfg: EngineConfig,
    cap_b: int,
    cap_p: int,
    cap_hot: int,
    colocated: bool = False,
):
    """The skew-resistant semi-join over the shards (the JAX package's
    per-chip body, split at its collectives).

    Exposed for composed plans (``models/pipeline.make_dist_pipeline`` with
    ``dist_join_engine="skew"``); ``dist_hash_join_skew`` is the standalone
    wrapper.  Returns (probe_out, cnt, nres, overflow, n_hot), a value a
    shard each; the last three are the same on every shard.

    ``colocated=True`` declares the inputs already hash-partitioned by key:
    the cold path's exchange would send every row to its own shard, so it is
    skipped.
    """
    ndev = mesh_size(mesh)
    b_active = [torch.arange(b.nrows, device=b.recid.device) < c for b, c in zip(bb, bc)]
    p_active = [torch.arange(b.nrows, device=b.recid.device) < c for b, c in zip(pb, pc)]
    bh = [key_hash(b, field) for b in bb]
    ph = [key_hash(b, field) for b in pb]

    def thresholds(counts):
        return [(t // (ndev * cfg.hh_factor)).clamp(min=1).to(torch.int32)
                for t in mesh.psum(counts)]

    hot_p = hot_hash_set(mesh, ph, p_active, cfg.hh_topk, thresholds(pc))
    # build-side heavy hitters too: a key with many duplicate build rows would
    # funnel them all to one shard's cap_b; on the hot path they are deduped
    # locally first, so one row a key a shard is gathered
    hot_b = hot_hash_set(mesh, bh, b_active, cfg.hh_topk, thresholds(bc))
    hot = [torch.cat([a, b]) for a, b in zip(hot_p, hot_b)]
    n_hot = [(h != SENTINEL).sum(dtype=torch.int32) for h in hot]
    b_hot = [in_hot_set(h, s) & a for h, s, a in zip(bh, hot, b_active)]
    p_hot = [in_hot_set(h, s) & a for h, s, a in zip(ph, hot, p_active)]

    # ---- hot path: replicate the hot build rows, probe locally -------------
    slices, live, hot_ovf = [], [], []
    for b, m in zip(bb, b_hot):
        rows, n = compact(b, m, cfg)
        # a key set: the local dedup bounds a shard's hot rows by the hot
        # keys (<= 2 * ndev * hh_topk <= cap_hot)
        rows, n = distinct_impl(rows, field, cfg, count=n)
        slices.append(rows.slice(0, min(cap_hot, rows.nrows)))
        live.append(n.clamp(max=cap_hot).reshape(1))
        hot_ovf.append((n - cap_hot).clamp(min=0))
    gathered = [RecordBatch(*cols) for cols in zip(
        *(mesh.all_gather([getattr(s, c) for s in slices])
          for c in ("recid", "num", "strw", "valid")))]
    gcounts = mesh.all_gather(live)  # int32[ndev]: each source's live hot rows
    matched_hot = []
    for g, gc, p, ph_ in zip(gathered, gcounts, pb, p_hot):
        g_active = (torch.arange(cap_hot, device=gc.device)[None, :] < gc[:, None]).reshape(-1)
        ghot, gn = compact(g, g_active, cfg)
        m, _, _ = hash_join_count_impl(ghot, p, field, cfg, build_count=gn, probe_count=None)
        matched_hot.append(m & ph_)  # only hot probe rows take this path

    # ---- cold path: the plain hash-partition shuffle -----------------------
    bcold = [compact(b, a & ~h, cfg) for b, a, h in zip(bb, b_active, b_hot)]
    pcold = [compact(b, a & ~h, cfg) for b, a, h in zip(pb, p_active, p_hot)]
    if colocated:
        # equal keys already share a shard: the shuffle would route every row
        # to itself
        brecv, btot = [r for r, _ in bcold], [n for _, n in bcold]
        precv, ptot = [r for r, _ in pcold], [n for _, n in pcold]
        ovf_cold = [torch.zeros((), dtype=torch.int32, device=d) for d in mesh.devices]
    else:
        brecv, btot, ovf1 = shuffle(mesh, [r for r, _ in bcold], [n for _, n in bcold],
                                    [hash_dest(r, field, ndev) for r, _ in bcold], cap_b, cfg)
        precv, ptot, ovf2 = shuffle(mesh, [r for r, _ in pcold], [n for _, n in pcold],
                                    [hash_dest(r, field, ndev) for r, _ in pcold], cap_p, cfg)
        ovf_cold = [a + b for a, b in zip(ovf1, ovf2)]

    # ---- combine: the hot block, then the cold block ----------------------
    outs, cnts, sums = [], [], []
    for p, mh, br, bt, pr, pt in zip(pb, matched_hot, brecv, btot, precv, ptot):
        mc, _, _ = hash_join_count_impl(br, pr, field, cfg, build_count=bt, probe_count=pt)
        hot_out, hot_cnt = compact(p, mh, cfg)
        cold_out, cold_cnt = compact(pr, mc, cfg)
        dev = hot_cnt.device
        keep = torch.cat([torch.arange(hot_out.nrows, device=dev) < hot_cnt,
                          torch.arange(cold_out.nrows, device=dev) < cold_cnt])
        out, cnt = compact(RecordBatch.concat([hot_out, cold_out]), keep, cfg)
        outs.append(out)
        cnts.append(cnt)
        sums.append(hot_cnt + cold_cnt)
    nres = mesh.psum(sums)
    ovf = [a + b for a, b in zip(ovf_cold, mesh.psum(hot_ovf))]
    return outs, cnts, nres, ovf, n_hot


def dist_hash_join_skew(
    mesh: Mesh,
    build: DistTable,
    probe: DistTable,
    field,
    cfg: EngineConfig = DEFAULT_CONFIG,
) -> tuple[DistTable, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Skew-resistant distributed semi-join (fields 0-2).

    Returns (probe_out, nres, overflow, n_hot): matched probe rows stay on
    the shard that joined them (hot rows never move; cold rows are joined
    where the shuffle sent them)."""
    ndev = mesh_size(mesh)
    per_b, per_p = build.rows_per_chip, probe.rows_per_chip
    cap_b = _shuffle_cap(per_b, ndev, cfg)
    cap_p = _shuffle_cap(per_p, ndev, cfg)
    # the hot list holds 2 * ndev * hh_topk hashes; after the local dedup a
    # shard contributes at most one build row a hot key
    cap_hot = min(max(2 * ndev * cfg.hh_topk, 64), per_b)
    out, cnt, nres, ovf, n_hot = skew_join_local(
        mesh, build.batches, build.counts, probe.batches, probe.counts, field, cfg,
        cap_b, cap_p, cap_hot)
    return DistTable(out, cnt), nres[0], ovf[0], n_hot[0]
