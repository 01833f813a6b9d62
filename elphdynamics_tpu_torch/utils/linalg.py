"""Dense factorisation helpers that a CUDA graph can capture.

The solver aids solve small batched systems inside the graphed sampler
calls (``dynamics/graphs.py``). PyTorch's default CUDA backend routes
``torch.cholesky_solve`` and the LU of ``torch.linalg.inv_ex`` on large
batches to MAGMA, which allocates device memory outside the caching
allocator and cannot be captured (on an NVIDIA H100 with torch
2.11.0+cu128, ``PERF.md`` §6). The helpers below give the same functions through captured libraries, on the
eager and the graphed call alike, so the two stay equal bit for bit; on
the CPU they are LAPACK's as before.
"""

from __future__ import annotations

import contextlib

import torch


def cholesky_solve(B: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """(L·Lᴴ)⁻¹·B for a lower Cholesky factor ``L`` ``[..., n, n]`` and
    ``B`` ``[..., n, m]``: the two triangular solves of
    ``torch.cholesky_solve`` (cuBLAS ``trsm`` on a card)."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mH, Y, upper=True)


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """PyTorch's CUDA linear algebra on cuSOLVER inside the block (no
    change on another device)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def inv_ex(A: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.inv_ex(A).inverse`` (no error check, so no host
    read), its LU on cuSOLVER on a card."""
    with _cusolver(A.device):
        return torch.linalg.inv_ex(A).inverse
