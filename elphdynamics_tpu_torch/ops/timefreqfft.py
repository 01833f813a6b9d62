"""Unitary map between antiperiodic imaginary time τ and frequency ω.

Counterpart of ``elphdynamics_tpu/ops/timefreqfft.py``: a phase twist
Θ(τ) = exp(−iπτ/Lτ) turns the antiperiodic boundary into a periodic one,
then an FFT along τ (the last axis) diagonalises time translations.

Θ is built on the host and uploaded once per (Lτ, device, dtype), then
kept: a captured call (``dynamics/graphs.py``) reads the kept tensor, and a
first upload during a CUDA graph capture raises.
"""

from __future__ import annotations

import numpy as np
import torch

from elphdynamics_tpu_torch.utils.dtypes import complex_of


def theta(Ltau: int) -> np.ndarray:
    return np.exp(-1j * np.pi * np.arange(Ltau) / Ltau)


# Θ on a device, per (Lτ, device, complex dtype)
_THETA: dict = {}


def theta_on(Ltau: int, device, dtype: torch.dtype) -> torch.Tensor:
    """Θ of length ``Ltau`` in the complex type of ``dtype`` on ``device``,
    uploaded on first use there and kept."""
    device = torch.device(device)
    dtype = complex_of(dtype)
    key = (Ltau, str(device), dtype)
    th = _THETA.get(key)
    if th is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the τ↔ω phase Θ (Lτ = {Ltau}) uploaded during a CUDA graph "
                               "capture: run the call once before capturing it")
        th = _THETA[key] = torch.as_tensor(theta(Ltau), dtype=dtype, device=device)
    return th


def tau_to_omega(v: torch.Tensor) -> torch.Tensor:
    """ν = F·Θ·v."""
    return torch.fft.fft(theta_on(v.shape[-1], v.device, v.dtype) * v, dim=-1)


def omega_to_tau(v: torch.Tensor, real: bool = True) -> torch.Tensor:
    """v = Θ†·F⁻¹·ν (real part when ``real``)."""
    th = theta_on(v.shape[-1], v.device, v.dtype)
    out = torch.conj(th) * torch.fft.ifft(v, dim=-1)
    return out.real if real else out
