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
    """Batched inner product ``Σ a·b`` over ``dim``, accumulated in float64.
    Complex inputs (complex hopping) give the real Hermitian product
    Re(a†·b) = Re(a)·Re(b) + Im(a)·Im(b): the inner product under which the
    Hermitian positive definite M†M is an SPD operator on ℝ²ⁿ, so the real
    CG machinery applies unchanged."""
    if a.is_complex() or b.is_complex():
        a, b = _as_complex(a), _as_complex(b)
        return fdot(a.real, b.real, dim) + fdot(a.imag, b.imag, dim)
    return fsum(a.to(torch.float64) * b.to(torch.float64), dim)


def fdot_fast(a: torch.Tensor, b: torch.Tensor, dim: DimArg = (-2, -1)) -> torch.Tensor:
    """The CG loop-body inner product. The JAX package ran it in hardware
    f32 on the TPU; here it accumulates in float64 like :func:`fdot`
    (choosing a cheaper accumulation is a later, measured change)."""
    return fdot(a, b, dim)


def complex_of(dtype: torch.dtype) -> torch.dtype:
    """The complex type of a real (or complex) dtype's precision."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def real_of(dtype: torch.dtype) -> torch.dtype:
    """The real type of a complex (or real) dtype's precision."""
    if not dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _as_complex(a: torch.Tensor) -> torch.Tensor:
    return a if a.is_complex() else a.to(complex_of(a.dtype))


def params_are_complex(params) -> bool:
    """True when any model-parameter tensor is complex: the complex-hopping
    (Peierls phase, twisted boundaries) path."""
    return any(torch.is_tensor(v) and v.is_complex() for v in vars(params).values())


def field_dtype(params, dtype: torch.dtype) -> torch.dtype:
    """The fermion-field dtype for real phonon fields of ``dtype``: its
    complex counterpart under complex hopping, else ``dtype`` itself."""
    return complex_of(dtype) if params_are_complex(params) else dtype


def pseudofermion_noise(shape, dtype: torch.dtype, device,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Spin-stacked pseudofermion Gaussians for the φ refresh. ``shape`` is
    ``(*batch, N, Lτ)``. A real ``dtype``: ``[*batch, 2, N, Lτ]``, one
    independent real field per spin. A complex ``dtype`` (complex hopping):
    the same two real fields packed as ONE stack entry
    ``[*batch, 1, N, Lτ] = R↑ + i·R↓``; under the real ℝ²ⁿ embedding this is
    the two-spin algorithm on the time-reversal-symmetric twist ensemble
    (spin ↓ sees the conjugate phases, weight |det M|²)."""
    shape = tuple(shape)
    full = shape[:-2] + (2,) + shape[-2:]
    R = torch.randn(full, dtype=real_of(dtype), device=device, generator=generator)
    if not dtype.is_complex:
        return R
    return torch.complex(R[..., 0:1, :, :], R[..., 1:2, :, :])


def trace_noise(shape, dtype: torch.dtype, device,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Gaussian probes for the stochastic Green's-function and trace
    estimators: unit normals with E[ggᵀ] = I for a real ``dtype``; circular
    complex normals with E[gg†] = I for a complex one (complex hopping:
    −2·Re[g†·∂M·M⁻¹g] then estimates the force −2·Re Tr[M⁻¹∂M])."""
    shape = tuple(shape)
    if not dtype.is_complex:
        return torch.randn(shape, dtype=dtype, device=device, generator=generator)
    g = torch.randn((2,) + shape, dtype=real_of(dtype), device=device, generator=generator)
    return torch.complex(g[0], g[1]) * 0.5 ** 0.5
