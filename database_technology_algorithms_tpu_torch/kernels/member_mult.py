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
from . import _lib


def member_multiplicity_cells(
    bwords: Sequence[torch.Tensor],
    n_bkeys: torch.Tensor,
    kwords: Sequence[torch.Tensor],
    n_kkeys: torch.Tensor | None = None,
    live_k: torch.Tensor | None = None,
) -> torch.Tensor:
    """For each of G cell pairs, the number of live build rows with the same
    key as each live query row (0 for a dead query row).

    `bwords` and `kwords` are the key's words, one int32[G, cap_b] and one
    int32[G, cap_k] tensor a word (u32 bits), most significant first.  The
    live build rows of pair g are its first ``n_bkeys[g]`` (int32[G]), in any
    order; query row j of pair g is live when ``j < n_kkeys[g]`` (int32[G],
    None: every row) and ``live_k[g, j]`` (bool[G, cap_k], None: every row).
    Returns int32[G, cap_k] counts.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    bwords, kwords = list(bwords), list(kwords)
    if not bwords or len(bwords) != len(kwords):
        raise ValueError("member_multiplicity: build and query keys need the same words, >= 1")
    if bwords[0].device.type == "cpu":
        return member_multiplicity_cells_plain(bwords, n_bkeys, kwords, n_kkeys, live_k)
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
    _lib.check_cuda("member_multiplicity n_bkeys", n_bkeys, torch.int32, dev)
    if n_bkeys.shape != (g,):
        raise ValueError("member_multiplicity: n_bkeys must be [G]")
    if n_kkeys is not None:
        _lib.check_cuda("member_multiplicity n_kkeys", n_kkeys, torch.int32, dev)
        if n_kkeys.shape != (g,):
            raise ValueError("member_multiplicity: n_kkeys must be [G]")
    if live_k is not None:
        _lib.check_cuda("member_multiplicity live_k", live_k, torch.bool, dev)
        if live_k.shape != (g, cap_k):
            raise ValueError("member_multiplicity: live_k must be [G, cap_k]")
    out = torch.empty((g, cap_k), dtype=torch.int32, device=dev)
    if g == 0 or cap_k == 0:
        return out
    lib = _lib.library()
    scratch = torch.empty(
        lib.dbt_member_mult_scratch_words(g, cap_b), dtype=torch.int32, device=dev
    )
    ones = (ctypes.c_int64 * len(bwords))(*[1] * len(bwords))  # contiguous cells: row stride 1
    with torch.cuda.device(dev):
        err = lib.dbt_member_mult(
            _lib.ptr_array(bwords), ones, _lib.ptr_array(kwords), ones, len(bwords),
            g, cap_b, cap_k, n_bkeys.data_ptr(),
            None if n_kkeys is None else n_kkeys.data_ptr(),
            None if live_k is None else live_k.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), _lib.stream_of(out),
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
        return torch.zeros((g, cap_k), dtype=torch.int32, device=dev)
    ids = torch.unique(torch.cat([rows_b, rows_k]), dim=0, return_inverse=True)[1]
    ids_b, ids_k = ids[: g * cap_b], ids[g * cap_b:]
    live_b = (torch.arange(cap_b, device=dev)[None, :] < n_bkeys.long()[:, None]).reshape(-1)
    per_id = torch.bincount(ids_b[live_b], minlength=int(ids.max()) + 1)
    live = torch.ones((g, cap_k), dtype=torch.bool, device=dev)
    if n_kkeys is not None:
        live &= torch.arange(cap_k, device=dev)[None, :] < n_kkeys.long()[:, None]
    if live_k is not None:
        live &= live_k
    return torch.where(live, per_id[ids_k].reshape(g, cap_k), 0).to(torch.int32)
