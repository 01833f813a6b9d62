"""Small numeric helpers.

Counterpart of ``elphdynamics_tpu/utils/math.py``.
"""

from __future__ import annotations

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
