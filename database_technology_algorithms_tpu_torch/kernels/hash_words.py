"""K8: the key hash (``csrc/hash_words.cu``) and its plain torch version.

Replaces the JAX package's ``hash_words`` (``ops/keys.py:110``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import U32_MASK, as_u32, u32_bits
from . import _lib

_FNV_PRIME = 16777619
_FNV_BASIS = 2166136261


def _basis(seed: int) -> int:
    """The seeded FNV basis.  The JAX package forms ``uint32(seed *
    0x9E3779B9)`` from a Python int, which refuses a product beyond 32 bits
    (any seed above 1); the port refuses the same seeds."""
    mixed = int(seed) * 0x9E3779B9
    if not 0 <= mixed <= U32_MASK:
        raise OverflowError(f"hash_words: seed {seed} * 0x9E3779B9 is out of bounds for uint32")
    return _FNV_BASIS ^ mixed


def hash_words(
    words: Sequence[torch.Tensor], seed: int = 0, skip_zero_from: int | None = None
) -> torch.Tensor:
    """FNV-1a over the bytes of the key words (int32[N] columns holding u32
    bits, possibly strided), low byte first, then the murmur3 finalizer.
    Returns int32[N] holding the u32 hash.

    ``skip_zero_from=k`` skips a zero word at any index >= k, which makes the
    hash of a NUL-normalized string key the same at every stored width;
    ``None`` hashes every word.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    words = list(words)
    if not words:
        raise ValueError("hash_words: at least one key word is required")
    basis = _basis(seed)
    if words[0].device.type == "cpu":
        return hash_words_plain(words, seed, skip_zero_from)
    dev = words[0].device
    if dev.type != "cuda":
        raise ValueError(f"hash_words: expected CUDA tensors, got {dev}")
    n = words[0].shape[0]
    _lib.check_columns("hash_words", words, n, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    skip = len(words) if skip_zero_from is None else max(int(skip_zero_from), 0)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_hash_words(
            _lib.ptr_array(words), _lib.stride_array(words), len(words), n,
            basis, skip, out.data_ptr(), _lib.stream_of(out),
        )
    _lib.raise_on_error(err, "hash_words")
    _lib.LAUNCHES["hash_words"] += 1
    return out


def hash_words_plain(
    words: Sequence[torch.Tensor], seed: int = 0, skip_zero_from: int | None = None
) -> torch.Tensor:
    """The same hash in int64 torch ops: the u32 values are widened, every
    product is masked back to 32 bits (int64 wraps mod 2^64, so the low 32
    bits stay right) and the shifts are of non-negative values."""
    words = list(words)
    n = words[0].shape[0]
    h = torch.full((n,), _basis(seed), dtype=torch.int64, device=words[0].device)
    for i, w in enumerate(words):
        w = as_u32(w)
        hw = h
        for shift in (0, 8, 16, 24):
            hw = ((hw ^ ((w >> shift) & 0xFF)) * _FNV_PRIME) & U32_MASK
        skip = skip_zero_from is not None and i >= skip_zero_from
        h = torch.where(w == 0, h, hw) if skip else hw
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & U32_MASK
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & U32_MASK
    h = h ^ (h >> 16)
    return u32_bits(h)
