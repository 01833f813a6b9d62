"""Accurate accumulation primitives, pseudofermion and probe noise.

Counterpart of ``elphdynamics_tpu/utils/dtypes.py``. Every reduction here
accumulates in float64 on every device: the H100 has float64 in hardware,
so the double-f32 (Veltkamp/Dekker) path the TPU needed is not carried over
(it also breaks under FMA contraction). Results are float64 tensors.

Used by the CG dot products and residual checks (:mod:`..solvers`) and by
the HMC energies, whose difference ΔH = H₁−H₀ cancels O(N·Lτ)-sized sums.
"""

from __future__ import annotations

import torch

DimArg = int | tuple[int, ...] | None


def fsum(a: torch.Tensor, dim: DimArg = None) -> torch.Tensor:
    """Sum with float64 accumulation (over all axes when ``dim`` is None)."""
    a = a.to(torch.float64)
    return a.sum() if dim is None else a.sum(dim=dim)


def fdot(a: torch.Tensor, b: torch.Tensor, dim: DimArg = (-2, -1)) -> torch.Tensor:
    """Batched real inner product ``Σ a·b`` over ``dim``, accumulated in
    float64."""
    if a.is_complex() or b.is_complex():
        raise NotImplementedError(
            "complex inner products belong to the complex-hopping slice "
            "(ROADMAP slice F)")
    return fsum(a.to(torch.float64) * b.to(torch.float64), dim)


def fdot_fast(a: torch.Tensor, b: torch.Tensor, dim: DimArg = (-2, -1)) -> torch.Tensor:
    """The CG loop-body inner product. The JAX package ran it in hardware
    f32 on the TPU; here it accumulates in float64 like :func:`fdot`
    (choosing a cheaper accumulation is a later, measured change)."""
    return fdot(a, b, dim)


def pseudofermion_noise(shape, dtype: torch.dtype, device,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Spin-stacked pseudofermion Gaussians ``[*batch, 2, N, Lτ]`` for the φ
    refresh (real hopping only: one independent real field per spin).

    ``shape`` is ``(*batch, N, Lτ)``; the spin axis is inserted before the
    last two axes."""
    shape = tuple(shape)
    full = shape[:-2] + (2,) + shape[-2:]
    return torch.randn(full, dtype=dtype, device=device, generator=generator)


def trace_noise(shape, dtype: torch.dtype, device,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Gaussian probes with E[ggᵀ] = I for the stochastic Green's-function
    and trace estimators (real hopping: unit normals). The complex probes of
    the complex-hopping path belong to ROADMAP slice F."""
    if dtype.is_complex:
        raise NotImplementedError("complex probe vectors: ROADMAP slice F")
    return torch.randn(tuple(shape), dtype=dtype, device=device, generator=generator)
