"""K16 and K17: the open-addressing hash set's build and probe
(``csrc/hash_set.cu``) and their plain torch versions.

Replaces the JAX package's ``build_hash_set`` and ``probe_hash_set``
(``ops/hash_table.py:50-146``), exactly where those are not: the one key
whose mix is ``EMPTY`` is never stored but flagged, and a key fails past
``engines_plan.insert_limit(max_probe)`` slots (see ``csrc/hash_set.cu``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..batch import U32_MASK, as_u32, u32_bits
from . import _lib, engines_plan, rowmove_plan

EMPTY = U32_MASK  # the empty slot's value


class HashSet(NamedTuple):
    """A built set: ``slots`` int32[size] holding u32 mixed keys or EMPTY,
    ``has_empty_key`` (0-d int32, 1 when the key whose mix is EMPTY is in
    the set) and ``n_failed`` (0-d int32, the live keys not stored)."""

    slots: torch.Tensor
    has_empty_key: torch.Tensor
    n_failed: torch.Tensor


def mix_u32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on u32 values held in int64 (bijective): the
    shifts are of non-negative values and each product is masked back to 32
    bits."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32_MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32_MASK
    return h ^ (h >> 16)


def hash_set_build(keys: torch.Tensor, size: int, count=None, limit: int = 64) -> HashSet:
    """Insert the first `count` keys (int32[N] holding u32 bits; None: all)
    into a table of `size` slots (a power of two), trying at most `limit`
    slots a key.  A count is an int or a 0-d integer tensor on the device.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    under ``engines_plan.hash_plan`` (after one fill launch: the slots to
    EMPTY, the flag and failure count to 0).
    """
    size, limit = int(size), int(limit)
    engines_plan.check_table("hash_set_build", size)
    if limit < 0:
        raise ValueError(f"hash_set_build: limit {limit} < 0")
    if keys.device.type == "cpu":
        return hash_set_build_plain(keys, size, count, limit)
    dev = keys.device
    _lib.check_cuda("hash_set_build keys", keys, torch.int32)
    n = keys.shape[0]
    engines_plan.check_rows("hash_set_build", n)
    slots = torch.empty(size, dtype=torch.int32, device=dev)
    meta = torch.empty(2, dtype=torch.int32, device=dev)
    cnt, cnt_host = rowmove_plan.count_arg(count, n, dev)
    plan = engines_plan.hash_plan(n, size, keys.data_ptr())
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_hash_set_build(
            keys.data_ptr(), n, None if cnt is None else cnt.data_ptr(), cnt_host,
            slots.data_ptr(), size, limit, meta.data_ptr(), plan.keys, plan.threads,
            plan.window, int(plan.vec), plan.blocks, _lib.stream_of(keys),
        )
    _lib.raise_on_error(err, "hash_set_build")
    _lib.LAUNCHES["hash_set_build"] += 1
    return HashSet(slots, meta[0], meta[1])


def hash_set_build_plain(keys: torch.Tensor, size: int, count=None, limit: int = 64) -> HashSet:
    """The same insertion in rounds: in round d every pending key reads the
    slot d past its home; of the keys that find it EMPTY the lowest row
    writes it, and a key that then reads its own value is done.  That is
    one order in which the kernel's compare-and-swaps may land (round d's
    before round d + 1's), so it stores the same set while no key fails."""
    n = keys.shape[0]
    dev = keys.device
    h = mix_u32(as_u32(keys))
    live = torch.ones(n, dtype=torch.bool, device=dev)
    if count is not None:
        live = rowmove_plan.live_positions(n, count, dev)
    has_empty = (live & (h == EMPTY)).any()
    pending = live & (h != EMPTY)
    table = torch.full((size,), EMPTY, dtype=torch.int64, device=dev)
    slot = h & (size - 1)
    rows = torch.arange(n, device=dev)
    for _ in range(limit):
        idx = rows[pending]
        if idx.numel() == 0:
            break
        s, hv = slot[idx], h[idx]
        free = table[s] == EMPTY
        winner = torch.full((size,), n, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(0, s[free], idx[free], "amin")
        won = free & (winner[s] == idx)
        table[s[won]] = hv[won]
        done = table[s] == hv
        pending[idx[done]] = False
        slot[idx[~done]] = (s[~done] + 1) & (size - 1)
    return HashSet(u32_bits(table), has_empty.to(torch.int32),
                   pending.sum(dtype=torch.int32))


def hash_set_probe(hs: HashSet, keys: torch.Tensor, count=None, max_probe: int = 64
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership of each key (int32[P], the first `count` live; None: all)
    in the set: linear probing from the key's home slot until its value, an
    EMPTY slot or `max_probe` slots; the key whose mix is EMPTY reads the
    flag.  Returns (found bool[P], mult int32[P]); a dead row is not found.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    size = hs.slots.shape[0]
    engines_plan.check_table("hash_set_probe", size)
    max_probe = min(max(int(max_probe), 0), engines_plan.MAX_ROWS)
    if keys.device.type == "cpu":
        return hash_set_probe_plain(hs, keys, count, max_probe)
    dev = keys.device
    _lib.check_cuda("hash_set_probe keys", keys, torch.int32)
    _lib.check_cuda("hash_set_probe slots", hs.slots, torch.int32, dev)
    _lib.check_cuda("hash_set_probe has_empty_key", hs.has_empty_key, torch.int32, dev)
    n = keys.shape[0]
    engines_plan.check_rows("hash_set_probe", n)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    mult = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return found, mult
    cnt, cnt_host = rowmove_plan.count_arg(count, n, dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_hash_set_probe(
            hs.slots.data_ptr(), size, hs.has_empty_key.data_ptr(), keys.data_ptr(), n,
            None if cnt is None else cnt.data_ptr(), cnt_host, max_probe,
            found.data_ptr(), mult.data_ptr(), _lib.stream_of(keys),
        )
    _lib.raise_on_error(err, "hash_set_probe")
    _lib.LAUNCHES["hash_set_probe"] += 1
    return found, mult


def hash_set_probe_plain(hs: HashSet, keys: torch.Tensor, count=None, max_probe: int = 64
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The same probe, all keys a step at a time."""
    n = keys.shape[0]
    dev = keys.device
    table = as_u32(hs.slots)
    size = table.shape[0]
    q = mix_u32(as_u32(keys))
    live = torch.ones(n, dtype=torch.bool, device=dev)
    if count is not None:
        live = rowmove_plan.live_positions(n, count, dev)
    found = live & (q == EMPTY) & (hs.has_empty_key != 0)
    active = live & (q != EMPTY)
    slot = q & (size - 1)
    for _ in range(max_probe):
        if not bool(active.any()):
            break
        cur = table[slot]
        hit = active & (cur == q)
        found |= hit
        active &= ~hit & (cur != EMPTY)
        slot = torch.where(active, (slot + 1) & (size - 1), slot)
    return found, found.to(torch.int32)
