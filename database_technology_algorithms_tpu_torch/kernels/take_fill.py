"""K4: record gather with fill (``csrc/take_fill.cu``, on the row-move engine
of ``csrc/rowmove.cuh``) and its plain torch version.

Replaces the JAX package's ``RecordBatch.take_fill`` (``batch.py:220``).
"""

from __future__ import annotations

import torch

from . import _lib, rowmove_plan


def take_fill(recid, num, strw, valid, idx, count=None):
    """Gather rows `idx` of the columns (recid, num int32[N], strw
    int32[N,K], valid bool[N]).  An index outside [-N, N) gives a zero row
    with valid False; a negative index counts from the end, as ``jnp.take``
    does.  With `count` (an int or a 0-d integer tensor on the device),
    positions at or past it are zero rows too: the JAX package's take_fill
    of ``where(arange(m) < count, idx, N)``.  Returns the four gathered
    columns.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if idx.device.type == "cpu":
        return take_fill_plain(recid, num, strw, valid, idx, count)
    dev = idx.device
    n, k = strw.shape
    _lib.check_cuda("take_fill idx", idx, torch.int32)
    for name, t, dt in (("recid", recid, torch.int32), ("num", num, torch.int32),
                        ("strw", strw, torch.int32), ("valid", valid, torch.bool)):
        _lib.check_cuda(f"take_fill {name}", t, dt, dev)
        if t.shape[0] != n:
            raise ValueError(f"take_fill: {name} has {t.shape[0]} rows, expected {n}")
    m = idx.shape[0]
    out = (
        torch.empty(m, dtype=torch.int32, device=dev),
        torch.empty(m, dtype=torch.int32, device=dev),
        torch.empty((m, k), dtype=torch.int32, device=dev),
        torch.empty(m, dtype=torch.bool, device=dev),
    )
    if m == 0:
        return out
    vec = rowmove_plan.access_words(k, strw.data_ptr(), out[2].data_ptr())
    rowmove_plan.check_shape("take_fill", n, m, k // vec)
    cnt, cnt_host = rowmove_plan.count_arg(count, m, dev)
    lib = _lib.library()
    with torch.cuda.device(dev):
        err = lib.dbt_take_fill(
            idx.data_ptr(), m, n, k,
            recid.data_ptr(), num.data_ptr(), strw.data_ptr(), valid.data_ptr(),
            *[t.data_ptr() for t in out],
            None if cnt is None else cnt.data_ptr(), cnt_host,
            vec, rowmove_plan.block_rows(k // vec, (n + m) * (9 + 4 * k)), _lib.stream_of(idx),
        )
    _lib.raise_on_error(err, "take_fill")
    _lib.LAUNCHES["take_fill"] += 1
    return out


def take_fill_plain(recid, num, strw, valid, idx, count=None):
    """The same gather as masked torch indexing."""
    n, m = recid.shape[0], idx.shape[0]
    if n == 0:
        return (recid.new_zeros(m), num.new_zeros(m),
                strw.new_zeros((m, strw.shape[1])), valid.new_zeros(m))
    j = idx.long()
    j = torch.where(j < 0, j + n, j)
    ok = (j >= 0) & (j < n)
    if count is not None:
        ok &= rowmove_plan.live_positions(m, count, idx.device)
    jc = torch.where(ok, j, 0)
    return (
        torch.where(ok, recid[jc], 0),
        torch.where(ok, num[jc], 0),
        torch.where(ok[:, None], strw[jc], 0),
        valid[jc] & ok,
    )
