"""Unitary map between antiperiodic imaginary time τ and frequency ω.

Counterpart of ``elphdynamics_tpu/ops/timefreqfft.py``: a phase twist
Θ(τ) = exp(−iπτ/Lτ) turns the antiperiodic boundary into a periodic one,
then an FFT along τ (the last axis) diagonalises time translations.
"""

from __future__ import annotations

import numpy as np
import torch

from elphdynamics_tpu_torch.utils.dtypes import complex_of


def theta(Ltau: int) -> np.ndarray:
    return np.exp(-1j * np.pi * np.arange(Ltau) / Ltau)


def tau_to_omega(v: torch.Tensor) -> torch.Tensor:
    """ν = F·Θ·v."""
    th = torch.as_tensor(theta(v.shape[-1]), dtype=complex_of(v.dtype), device=v.device)
    return torch.fft.fft(th * v, dim=-1)


def omega_to_tau(v: torch.Tensor, real: bool = True) -> torch.Tensor:
    """v = Θ†·F⁻¹·ν (real part when ``real``)."""
    th = torch.as_tensor(theta(v.shape[-1]), dtype=complex_of(v.dtype), device=v.device)
    out = torch.conj(th) * torch.fft.ifft(v, dim=-1)
    return out.real if real else out
