"""The pipeline's (inactive, key, row) view sort.

Port of the u32 part of the JAX package's ``ops/sort.py``.  The JAX
package packs (inact, key, row) into two u32 sort operands because
``lax.sort`` costs per operand on the TPU; the radix kernel K1
(``kernels/radix_sort.py``) sorts by those three words directly.  The
string-key path (``sort_keys``, fields 2 and 3) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..batch import as_u32
from ..kernels.radix_sort import view_sort


class SortedView(NamedTuple):
    """A key sort without row movement: ``perm`` (sorted position -> row),
    ``adj_eq`` (row equals the previous row's key) and carried extras."""

    perm: torch.Tensor
    adj_eq: torch.Tensor
    extras: tuple


def packed_u32_view_sort(inact: torch.Tensor, key: torch.Tensor, extra: tuple = ()):
    """Sort by (inact, u32 key, row index); returns (s_key, perm, s_act,
    extras) as the JAX function does (``ops/sort.py:190``)."""
    return view_sort(inact, key, extra)


def view_sort_3key(inact: torch.Tensor, key: torch.Tensor, extra: tuple = ()):
    """The same order as three sort words (``packed_u32_sorts=False``).

    On the card the radix kernel already sorts by exactly these words, so
    this form launches it too; on the CPU it is a lexicographic sort by
    stable passes, least significant word first.
    """
    if key.device.type != "cpu":
        return view_sort(inact, key, extra)
    perm = torch.sort(as_u32(key), stable=True).indices
    perm = perm[torch.sort(inact[perm].to(torch.uint8), stable=True).indices]
    return key[perm], perm.to(torch.int32), ~inact[perm], tuple(w[perm] for w in extra)
