"""Columnar record batches on torch tensors.

The layout is the JAX package's (``database_technology_algorithms_tpu/batch.py``),
a structure of arrays over 32-bit words:

    recid : u32[N]
    num   : u32[N]
    strw  : u32[N, K]   string bytes packed big-endian, 4 per word,
                        NUL-normalized, zero-padded; K from STR_WIDTH_BUCKETS
    valid : bool[N]

**The u32 representation.**  Every u32 word is held as a ``torch.int32``
tensor carrying the same bit pattern.  torch's ``uint32`` has no shifts or
comparisons and its sums promote to int64, so it cannot carry the engine's
arithmetic.  The CUDA kernels take these ``int32`` buffers and read them as
``uint32_t``.  The plain torch paths widen to int64 (``as_u32``) wherever
order, shifts or wrapping sums matter, and narrow back with ``u32_bits``.
Conversion to and from numpy ``uint32`` happens only at the package boundary
(``from_numpy``, ``to_numpy``, ``from_jax_arrays``, the block codec).

Narrow-width storage: the logical string column is 32 words wide; a batch
stores only the smallest bucket K that covers its longest string, which is
exact because NUL-normalization makes every word past the string zero.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils.checks import resolve_device

STR_LENGTH = 120  # reference STR_LENGTH, dbtproj.h:16
STR_PAD = 128  # logical string width (bytes)
STR_WORDS = STR_PAD // 4
MAX_RECORDS_PER_BLOCK = 100  # dbtproj.h:17

STR_WIDTH_BUCKETS = (2, 4, 8, 16, 32)

U32_MASK = 0xFFFFFFFF


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their u32 values, as int64."""
    return x.long() & U32_MASK


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 tensor holding their low 32 bits (wraps mod 2^32)."""
    low = x & U32_MASK
    return torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)


def u32_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """numpy u32 array -> int32 tensor with the same bits on `device`."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def torch_to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy u32 array with the same bits."""
    return t.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def bucket_str_words(nwords: int) -> int:
    """Smallest permitted static width covering `nwords` live words."""
    for b in STR_WIDTH_BUCKETS:
        if b >= nwords:
            return b
    return STR_WORDS


def narrow_str_bytes(strs: np.ndarray) -> np.ndarray:
    """Trim a host byte matrix to the smallest covering bucket width."""
    strs = np.ascontiguousarray(strs, dtype=np.uint8)
    n = strs.shape[0]
    nz = np.flatnonzero(strs.any(axis=0)) if n else np.array([], np.int64)
    live_bytes = int(nz[-1]) + 1 if nz.size else 0
    width = 4 * bucket_str_words(-(-live_bytes // 4))
    if strs.shape[1] == width:
        return strs
    if strs.shape[1] > width:
        return strs[:, :width]
    out = np.zeros((n, width), dtype=np.uint8)
    out[:, : strs.shape[1]] = strs
    return out


FIELD_RECID = 0
FIELD_NUM = 1
FIELD_STR = 2
FIELD_NUMSTR = 3

_FIELD_ALIASES = {
    "0": 0, "1": 1, "2": 2, "3": 3,
    0: 0, 1: 1, 2: 2, 3: 3,
    "recid": 0, "num": 1, "str": 2, "numstr": 3,
}


def canonical_field(field) -> int:
    """Map a reference-style field selector (char '0'..'3', int, or name) to int."""
    try:
        return _FIELD_ALIASES[field]
    except KeyError:
        raise ValueError(f"invalid field selector {field!r}; expected 0..3") from None


def pack_str_bytes(strs_u8: np.ndarray) -> np.ndarray:
    """Host: uint8[N,4K] -> big-endian uint32[N,K]."""
    strs_u8 = np.ascontiguousarray(strs_u8, dtype=np.uint8)
    return strs_u8.view(">u4").astype(np.uint32)


def unpack_str_words(strw: np.ndarray) -> np.ndarray:
    """Host: uint32[N,K] -> uint8[N,4K]."""
    k = strw.shape[1]
    return (
        np.ascontiguousarray(strw, dtype=np.uint32)
        .astype(">u4")
        .view(np.uint8)
        .reshape(-1, 4 * k)
    )


def normalize_str_bytes(strs: np.ndarray) -> np.ndarray:
    """Zero every byte at or after the first NUL, per row (host numpy)."""
    strs = np.ascontiguousarray(strs, dtype=np.uint8)
    keep = np.cumprod(strs != 0, axis=1, dtype=np.uint8).astype(bool)
    return np.where(keep, strs, 0)


@dataclasses.dataclass
class RecordBatch:
    """A columnar batch of records. All columns share length N and device."""

    recid: torch.Tensor  # int32[N] (u32 bits)
    num: torch.Tensor  # int32[N] (u32 bits)
    strw: torch.Tensor  # int32[N, K] (u32 bits), big-endian packed
    valid: torch.Tensor  # bool[N]

    @property
    def nrows(self) -> int:
        return self.recid.shape[0]

    @property
    def str_words(self) -> int:
        return self.strw.shape[1]

    def __len__(self) -> int:
        return self.nrows

    def pad_str_words(self, k: int) -> "RecordBatch":
        """Widen the string column to k words (zero-pad; no-op if already >=)."""
        cur = self.str_words
        if cur >= k:
            return self
        pad = self.strw.new_zeros((self.nrows, k - cur))
        return dataclasses.replace(self, strw=torch.cat([self.strw, pad], dim=1))

    def take_fill(self, idx: torch.Tensor, count=None) -> "RecordBatch":
        """Gather rows by index; an index outside [-N, N), or a position at
        or past `count` (None: none), gives a zero row with ``valid=False``
        (kernels/take_fill.py)."""
        from .kernels.take_fill import take_fill

        return RecordBatch(*take_fill(self.recid, self.num, self.strw, self.valid, idx, count))

    def take(self, idx: torch.Tensor) -> "RecordBatch":
        """Gather rows by index, every index in [-N, N) (a permutation, a
        sorted view's ``perm``); the record gather kernel as ``take_fill``."""
        return self.take_fill(idx)

    def payload_words(self) -> list[torch.Tensor]:
        """Every live column as an int32 word (the placement route's form):
        recid, num, valid as a 0/1 word, then the K string words (columns
        of ``strw``, strided).  Words past K need not move: the
        narrow-width invariant makes them zero."""
        return [self.recid, self.num, self.valid.to(torch.int32)] + [
            self.strw[:, j] for j in range(self.str_words)]

    @staticmethod
    def from_payload_words(words: list[torch.Tensor]) -> "RecordBatch":
        """The batch of ``payload_words()`` (valid is the third word != 0)."""
        return RecordBatch(recid=words[0], num=words[1],
                           strw=torch.stack(list(words[3:]), dim=1), valid=words[2] != 0)

    def slice(self, start: int, size: int) -> "RecordBatch":
        """Rows [start, start + size), as views."""
        end = start + size
        return RecordBatch(
            recid=self.recid[start:end],
            num=self.num[start:end],
            strw=self.strw[start:end],
            valid=self.valid[start:end],
        )

    @staticmethod
    def concat(batches: list["RecordBatch"]) -> "RecordBatch":
        k = max(b.str_words for b in batches)
        batches = [b.pad_str_words(k) for b in batches]
        return RecordBatch(
            recid=torch.cat([b.recid for b in batches]),
            num=torch.cat([b.num for b in batches]),
            strw=torch.cat([b.strw for b in batches]),
            valid=torch.cat([b.valid for b in batches]),
        )

    # ---- host boundary -----------------------------------------------------

    @staticmethod
    def from_numpy(
        recid: np.ndarray,
        num: np.ndarray,
        strs: Optional[np.ndarray] = None,
        valid: Optional[np.ndarray] = None,
        normalize: bool = True,
        device=None,
    ) -> "RecordBatch":
        """Build a batch from host arrays (`strs` is uint8[N, <=128] bytes)
        on `device` (default: the card)."""
        dev = resolve_device(device)
        n = recid.shape[0]
        if strs is None:
            strs = np.zeros((n, 8), dtype=np.uint8)
        strs = np.ascontiguousarray(strs, dtype=np.uint8)
        if normalize:
            strs = normalize_str_bytes(strs)
        strs = narrow_str_bytes(strs)
        if valid is None:
            valid = np.ones(n, dtype=bool)
        return RecordBatch(
            recid=u32_to_torch(recid, dev),
            num=u32_to_torch(num, dev),
            strw=u32_to_torch(pack_str_bytes(strs), dev),
            valid=torch.from_numpy(np.asarray(valid, dtype=bool).copy()).to(dev),
        )

    @staticmethod
    def from_jax_arrays(recid, num, strw, valid, device=None) -> "RecordBatch":
        """Build a batch from the four columns of a JAX-package ``RecordBatch``
        (as numpy: u32 recid/num, u32[N,K] strw, bool valid), word for word,
        so both packages run on identical inputs."""
        dev = resolve_device(device)
        return RecordBatch(
            recid=u32_to_torch(np.asarray(recid), dev),
            num=u32_to_torch(np.asarray(num), dev),
            strw=u32_to_torch(np.asarray(strw), dev),
            valid=torch.from_numpy(np.asarray(valid, dtype=bool).copy()).to(dev),
        )

    def to_numpy(self) -> dict:
        """Host columns with the byte-view string column (`strs` u8[N,128])."""
        narrow = unpack_str_words(torch_to_u32(self.strw).reshape(self.nrows, self.str_words))
        strs = np.zeros((self.nrows, STR_PAD), dtype=np.uint8)
        strs[:, : narrow.shape[1]] = narrow
        return {
            "recid": torch_to_u32(self.recid),
            "num": torch_to_u32(self.num),
            "strs": strs,
            "valid": self.valid.cpu().numpy(),
        }

    def str_list(self) -> list[bytes]:
        """The strings as Python bytes, each up to its first NUL (for tests
        and debugging)."""
        raw = self.to_numpy()["strs"][:, :STR_LENGTH]
        out = []
        for row in raw:
            nz = np.nonzero(row == 0)[0]
            end = nz[0] if len(nz) else STR_LENGTH
            out.append(row[:end].tobytes())
        return out


def make_batch_from_strings(recid: np.ndarray, num: np.ndarray, strings: list[bytes],
                            device=None) -> RecordBatch:
    """A batch from Python byte strings, each cut to ``STR_LENGTH`` bytes,
    on `device` (default: the card)."""
    n = len(strings)
    strs = np.zeros((n, STR_PAD), dtype=np.uint8)
    for i, s in enumerate(strings):
        b = np.frombuffer(s[:STR_LENGTH], dtype=np.uint8)
        strs[i, : len(b)] = b
    return RecordBatch.from_numpy(
        np.asarray(recid, dtype=np.uint32), np.asarray(num, dtype=np.uint32), strs,
        device=device,
    )
