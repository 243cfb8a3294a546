"""K10: build multiplicity of query keys over cell pairs
(``csrc/member_mult.cu``) and its plain torch version.

Replaces the JAX package's ``member_multiplicity``
(``ops/hash_join.py:256``) and the batched form the tiled join makes of it
with ``jax.vmap`` (``ops/hash_join.py:459-469``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..batch import as_u32
from . import _lib, cells_plan


def member_multiplicity_cells(
    bwords: Sequence[torch.Tensor],
    n_bkeys: torch.Tensor,
    kwords: Sequence[torch.Tensor],
    n_kkeys: torch.Tensor | None = None,
    live_k: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    out_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """For each of G cell pairs, the number of live build rows with the same
    key as each live query row (0 for a dead query row).

    `bwords` and `kwords` are the key's words, one int32[G, cap_b] and one
    int32[G, cap_k] tensor a word (u32 bits), most significant first.  The
    live build rows of pair g are its first ``n_bkeys[g]`` (int32[G]), in any
    order; query row j of pair g is live when ``j < n_kkeys[g]`` (int32[G],
    None: every row) and ``live_k[g, j]`` (bool[G, cap_k], None: every row).
    Returns int32[G, cap_k] counts.  Given `out` (int32[P]) and `out_pos`
    (int32[G]), the counts of rows ``j < n_kkeys[g]`` go to
    ``out[out_pos[g] + j]`` instead, every other element of `out` is left as
    it is, and `out` is returned: the occupied slots of all pairs compacted,
    where `out_pos` is the exclusive sum of `n_kkeys`.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    A pair's build rows past ``cells_plan.MAX_TABLE_BUILD`` go in parts of
    ``cells_plan.table_part`` rows (one launch each on the card), whose
    counts are added on the device.
    """
    bwords, kwords = list(bwords), list(kwords)
    if not bwords or len(bwords) != len(kwords):
        raise ValueError("member_multiplicity: build and query keys need the same words, >= 1")
    if (out is None) != (out_pos is None) or (out is not None and n_kkeys is None):
        raise ValueError("member_multiplicity: out and out_pos go together, with n_kkeys")
    cap_b = bwords[0].shape[-1]
    part = cells_plan.table_part(cap_b)
    if part < cap_b:
        for lo in range(0, cap_b, part):
            hi = min(lo + part, cap_b)
            args = ([w[:, lo:hi].contiguous() for w in bwords],
                    (n_bkeys - lo).clamp(0, hi - lo).to(torch.int32), kwords, n_kkeys, live_k)
            if lo == 0:
                out = member_multiplicity_cells(*args, out=out, out_pos=out_pos)
            elif out_pos is None:
                out += member_multiplicity_cells(*args)
            else:
                out += member_multiplicity_cells(*args, out=torch.zeros_like(out),
                                                 out_pos=out_pos)
        return out
    if bwords[0].device.type == "cpu":
        return member_multiplicity_cells_plain(bwords, n_bkeys, kwords, n_kkeys, live_k,
                                               out, out_pos)
    dev = bwords[0].device
    if dev.type != "cuda":
        raise ValueError(f"member_multiplicity: expected CUDA tensors, got {dev}")
    if bwords[0].dim() != 2 or kwords[0].dim() != 2 or bwords[0].shape[0] != kwords[0].shape[0]:
        raise ValueError("member_multiplicity: words must be [G, cap_b] and [G, cap_k]")
    g, cap_b = bwords[0].shape
    cap_k = kwords[0].shape[1]
    for name, ws, shape in (("build", bwords, (g, cap_b)), ("query", kwords, (g, cap_k))):
        for w in ws:
            _lib.check_cuda(f"member_multiplicity {name} word", w, torch.int32, dev)
            if w.shape != shape:
                raise ValueError(f"member_multiplicity: {name} word {tuple(w.shape)} != {shape}")
    for name, t, shape in (("n_bkeys", n_bkeys, (g,)), ("n_kkeys", n_kkeys, (g,)),
                           ("out_pos", out_pos, (g,))):
        if t is not None:
            _lib.check_cuda(f"member_multiplicity {name}", t, torch.int32, dev)
            if t.shape != shape:
                raise ValueError(f"member_multiplicity: {name} must be [G]")
    if live_k is not None:
        _lib.check_cuda("member_multiplicity live_k", live_k, torch.bool, dev)
        if live_k.shape != (g, cap_k):
            raise ValueError("member_multiplicity: live_k must be [G, cap_k]")
    if out is None:
        out = torch.empty((g, cap_k), dtype=torch.int32, device=dev)
    else:
        _lib.check_cuda("member_multiplicity out", out, torch.int32, dev)
        if out.dim() != 1:
            raise ValueError("member_multiplicity: out must be [P]")
    if g == 0 or cap_k == 0:
        return out
    m = len(bwords)
    cells_plan.check_table("member_multiplicity", cap_b)
    shared = cells_plan.table_cap(cap_b, m, cells_plan.TABLE_BYTES)
    words = cells_plan.table_scratch_words(g, cap_b, m, shared)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    ones = (ctypes.c_int64 * m)(*[1] * m)  # contiguous cells: row stride 1
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_member_mult(
            _lib.ptr_array(bwords), ones, _lib.ptr_array(kwords), ones, m,
            g, cap_b, cap_k, n_bkeys.data_ptr(),
            None if n_kkeys is None else n_kkeys.data_ptr(),
            None if live_k is None else live_k.data_ptr(),
            out.data_ptr(), None if out_pos is None else out_pos.data_ptr(),
            scratch.data_ptr(), words, shared, cells_plan.TABLE_THREADS, _lib.stream_of(out),
        )
    _lib.raise_on_error(err, "member_multiplicity")
    _lib.LAUNCHES["member_mult"] += 1
    return out


def member_multiplicity_cells_plain(
    bwords: Sequence[torch.Tensor],
    n_bkeys: torch.Tensor,
    kwords: Sequence[torch.Tensor],
    n_kkeys: torch.Tensor | None = None,
    live_k: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    out_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """The same counts from key identities: the (pair, key words) rows of
    both sides are numbered by ``torch.unique``, the live build rows are
    counted per number, and each live query row reads its number's count."""
    g, cap_b = bwords[0].shape
    cap_k = kwords[0].shape[1]
    dev = bwords[0].device
    pair_b = torch.arange(g, device=dev)[:, None].expand(g, cap_b)
    pair_k = torch.arange(g, device=dev)[:, None].expand(g, cap_k)
    width = 1 + len(bwords)
    rows_b = torch.stack([pair_b] + [as_u32(w) for w in bwords], dim=-1).reshape(g * cap_b, width)
    rows_k = torch.stack([pair_k] + [as_u32(w) for w in kwords], dim=-1).reshape(g * cap_k, width)
    if g * cap_k == 0:
        counts = torch.zeros((g, cap_k), dtype=torch.int32, device=dev)
    else:
        ids = torch.unique(torch.cat([rows_b, rows_k]), dim=0, return_inverse=True)[1]
        ids_b, ids_k = ids[: g * cap_b], ids[g * cap_b:]
        live_b = (torch.arange(cap_b, device=dev)[None, :] < n_bkeys.long()[:, None]).reshape(-1)
        per_id = torch.bincount(ids_b[live_b], minlength=int(ids.max()) + 1)
        live = torch.ones((g, cap_k), dtype=torch.bool, device=dev)
        if n_kkeys is not None:
            live &= torch.arange(cap_k, device=dev)[None, :] < n_kkeys.long()[:, None]
        if live_k is not None:
            live &= live_k
        counts = torch.where(live, per_id[ids_k].reshape(g, cap_k), 0).to(torch.int32)
    if out is None:
        return counts
    rows = torch.arange(cap_k, device=dev)[None, :] < n_kkeys.long().clamp(0, cap_k)[:, None]
    place = out_pos.long()[:, None] + torch.arange(cap_k, device=dev)[None, :]
    out[place[rows]] = counts[rows]
    return out
