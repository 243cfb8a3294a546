"""Reader/writer for the reference engine's binary block file format
(numpy copy of the JAX package's ``io/blockfile.py``).

    record_t (140 B): recid u32 | num u32 | str char[120] | valid u8 |
                      pad[3] | dummy1 u32 | dummy2 u32
    block_t (14016 B): blockid u32 | nreserved u32 | entries record_t[100] |
                       valid u8 | misc u8 | pad[2] | dummy u32
"""

from __future__ import annotations

import numpy as np

from ..batch import (
    MAX_RECORDS_PER_BLOCK,
    STR_LENGTH,
    STR_PAD,
    RecordBatch,
    normalize_str_bytes,
)

RECORD_SIZE = 140
BLOCK_SIZE = 14016

RECORD_DTYPE = np.dtype(
    {
        "names": ["recid", "num", "str", "valid", "dummy1", "dummy2"],
        "formats": ["<u4", "<u4", f"({STR_LENGTH},)u1", "u1", "<u4", "<u4"],
        "offsets": [0, 4, 8, 128, 132, 136],
        "itemsize": RECORD_SIZE,
    }
)

BLOCK_DTYPE = np.dtype(
    {
        "names": ["blockid", "nreserved", "entries", "valid", "misc", "dummy"],
        "formats": ["<u4", "<u4", (RECORD_DTYPE, (MAX_RECORDS_PER_BLOCK,)), "u1", "u1", "<u4"],
        "offsets": [0, 4, 8, 14008, 14009, 14012],
        "itemsize": BLOCK_SIZE,
    }
)


def decode_blocks_span(raw: np.ndarray) -> dict:
    """Decode a contiguous byte span of whole blocks into SoA columns,
    honouring each block's ``nreserved`` header."""
    nblocks = len(raw) // BLOCK_SIZE
    blocks = np.ascontiguousarray(raw[: nblocks * BLOCK_SIZE]).view(BLOCK_DTYPE)
    nres = np.minimum(blocks["nreserved"], MAX_RECORDS_PER_BLOCK).astype(np.int64)
    total = int(nres.sum())

    entries = blocks["entries"]
    mask = np.arange(MAX_RECORDS_PER_BLOCK)[None, :] < nres[:, None]

    strs = np.zeros((total, STR_PAD), dtype=np.uint8)
    strs[:, :STR_LENGTH] = entries["str"][mask]
    return {
        "recid": entries["recid"][mask].astype(np.uint32),
        "num": entries["num"][mask].astype(np.uint32),
        "strs": normalize_str_bytes(strs),
        "valid": entries["valid"][mask].astype(bool),
    }


def read_blockfile_numpy(path: str) -> dict:
    """Parse a block file into host SoA numpy columns."""
    return decode_blocks_span(np.fromfile(path, dtype=np.uint8))


def read_blockfile(path: str, device=None) -> RecordBatch:
    """Read a block file into a batch on `device` (default: the card),
    through the native library where it builds (``io/native.py``), else
    through the numpy codec; both give the same columns."""
    from .native import read_blockfile_native

    cols = read_blockfile_native(path)
    if cols is None:
        cols = read_blockfile_numpy(path)
    return RecordBatch.from_numpy(
        cols["recid"], cols["num"], cols["strs"], cols["valid"],
        normalize=False, device=device,
    )


def _encode_blocks(cols: dict, start_blockid: int, full_header: bool) -> np.ndarray:
    """Encode SoA columns as an array of reference-format blocks."""
    recid = np.asarray(cols["recid"], dtype=np.uint32)
    num = np.asarray(cols["num"], dtype=np.uint32)
    strs = np.asarray(cols["strs"], dtype=np.uint8)
    valid = np.asarray(cols.get("valid", np.ones(len(recid), bool)))
    n = len(recid)
    nblocks = -(-n // MAX_RECORDS_PER_BLOCK) if n else 0

    blocks = np.zeros(nblocks, dtype=BLOCK_DTYPE)
    pad_n = nblocks * MAX_RECORDS_PER_BLOCK

    def padcol(a, shape_tail=()):
        out = np.zeros((pad_n,) + shape_tail, dtype=a.dtype)
        out[:n] = a
        return out.reshape((nblocks, MAX_RECORDS_PER_BLOCK) + shape_tail)

    if nblocks:
        entries = blocks["entries"]
        entries["recid"] = padcol(recid)
        entries["num"] = padcol(num)
        entries["str"] = padcol(strs[:, :STR_LENGTH], (STR_LENGTH,))
        entries["valid"] = padcol(valid.astype(np.uint8))
        blocks["blockid"] = np.arange(
            start_blockid, start_blockid + nblocks, dtype=np.uint32
        )
        counts = np.full(nblocks, MAX_RECORDS_PER_BLOCK, dtype=np.uint32)
        if n % MAX_RECORDS_PER_BLOCK and full_header:
            counts[-1] = n % MAX_RECORDS_PER_BLOCK
        blocks["nreserved"] = counts
        # the reference merge phase reads block.dummy as its unconsumed-record
        # counter and needs dummy == nreserved on input (main.cpp:70)
        blocks["dummy"] = counts
        blocks["valid"] = 1
    return blocks


def write_blockfile(path: str, batch_or_cols, full_header: bool = True) -> int:
    """Write a batch (or SoA columns) as reference-format blocks; returns the
    number of blocks written."""
    if isinstance(batch_or_cols, RecordBatch):
        cols = batch_or_cols.to_numpy()
    else:
        cols = batch_or_cols
    blocks = _encode_blocks(cols, 0, full_header)
    blocks.tofile(path)
    return len(blocks)


class BlockFileWriter:
    """Streaming block-file writer: append column chunks in bounded memory.

    The external drivers' output sink.  It holds at most one partial block
    between appends (the reference's single buffered output block,
    ``DatabaseProject.cpp:433-443``), and its block ids run on across
    appends, so the file equals ``write_blockfile`` of the concatenated
    chunks, byte for byte.
    """

    def __init__(self, path: str, full_header: bool = True):
        self.f = open(path, "wb")
        self.full_header = full_header
        self.blockid = 0
        self.nrows = 0
        self._tail: dict | None = None  # rows of the pending partial block

    def append(self, cols: dict) -> None:
        n = len(cols["recid"])
        if n == 0:
            return
        self.nrows += n
        if self._tail is not None:
            cols = {
                k: np.concatenate([self._tail[k], np.asarray(cols[k])])
                for k in self._tail
            }
            self._tail = None
        total = len(cols["recid"])
        full = (total // MAX_RECORDS_PER_BLOCK) * MAX_RECORDS_PER_BLOCK
        if full:
            head = {k: np.asarray(v)[:full] for k, v in cols.items()}
            blocks = _encode_blocks(head, self.blockid, self.full_header)
            blocks.tofile(self.f)
            self.blockid += len(blocks)
        if total > full:
            self._tail = {k: np.asarray(v)[full:] for k, v in cols.items()}

    def close(self) -> int:
        """Flush the final partial block; returns the blocks written."""
        if self._tail is not None:
            blocks = _encode_blocks(self._tail, self.blockid, self.full_header)
            blocks.tofile(self.f)
            self.blockid += len(blocks)
            self._tail = None
        self.f.close()
        return self.blockid

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
