"""Small numeric helpers.

Counterpart of ``elphdynamics_tpu/utils/math.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def simpson(f: torch.Tensor, dx: float) -> torch.Tensor:
    """Simpson integration over the leading axis of ``f`` (trailing axes
    batched): composite Simpson over the odd-length prefix plus a 3-point
    correction for an even number of samples, the JAX package's rule."""
    L = f.shape[0]
    total = torch.zeros(f.shape[1:], dtype=f.dtype, device=f.device)
    if L >= 3:
        idx = 2 * torch.arange((L - 1) // 2, device=f.device)
        total = total + dx * (f[idx] / 3 + 4 * f[idx + 1] / 3 + f[idx + 2] / 3).sum(dim=0)
    if L % 2 == 0 and L >= 3:
        total = total + dx * (5 / 12 * f[L - 1] + 2 / 3 * f[L - 2] - 1 / 12 * f[L - 3])
    return total


def add_plan(index, n: int, keep=None):
    """The fixed order of an ``index_add`` of sources onto ``n`` rows:
    source k goes to row ``index[k]`` (host integers; a row may repeat),
    sources where ``keep`` is False nowhere. Returns ``(members, valid)``:
    ``members[s, r]`` is the source of row r's s-th add, in ascending
    source order, ``valid[s, r]`` whether row r has an s-th add (host
    arrays, ``[S, n]``)."""
    index = np.asarray(index, dtype=np.int64)
    src = np.arange(index.size) if keep is None else np.flatnonzero(np.asarray(keep))
    rows = index[src]
    order = np.argsort(rows, kind="stable")
    rows, src = rows[order], src[order]
    counts = np.bincount(rows, minlength=n)
    slot = np.arange(rows.size) - (np.cumsum(counts) - counts)[rows]
    members = np.zeros((max(int(counts.max(initial=0)), 1), n), dtype=np.int64)
    valid = np.zeros(members.shape, dtype=bool)
    members[slot, rows] = src
    valid[slot, rows] = True
    return members, valid


def ordered_add(d: torch.Tensor, src: torch.Tensor, members: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """``d`` plus the rows of ``src`` (along dim −2) that :func:`add_plan`
    sends to each row of ``d``, added one slot at a time by gathers, never
    by an atomic scatter: the same bits on every run and device, and on
    the CPU those of ``d.index_add(-2, index, src)``, which adds in source
    order (as the JAX package's scatter-add does). ``members`` and
    ``valid`` are the plan on ``d``'s device, ``valid`` shaped ``[S, n,
    1]``."""
    for s in range(members.shape[0]):
        d = torch.where(valid[s], d + src.index_select(-2, members[s]), d)
    return d
