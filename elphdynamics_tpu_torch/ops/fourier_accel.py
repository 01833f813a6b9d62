"""Fourier acceleration: diagonal-in-(phonon, ω) mass matrices.

Counterpart of ``elphdynamics_tpu/ops/fourier_accel.py``. The tables are
``[Nph, Lτ]`` spectra built on the host; applying ``table^power`` is
``ifft(table^power · fft(v))`` along τ. The spectra are symmetric in k, so
that map is a REAL circulant: for Lτ <= 256 it is applied as one
``[Lτ, Lτ]`` matmul per distinct spectrum (the JAX package's form, kept so
the numbers match). The circulants are built once, when a
:class:`MassOperator` is constructed (the HMC step builds one).
"""

from __future__ import annotations

import numpy as np
import torch


def build_Q(omega: np.ndarray, dtau: float, Ltau: int, blocks) -> np.ndarray:
    """Langevin-convention acceleration table (blocks: dicts with
    ``omega_min, omega_max, mass``; open frequency interval)."""
    omega = np.asarray(omega, dtype=np.float64)
    k = np.arange(Ltau)
    Q = np.ones((omega.shape[0], Ltau))
    for blk in blocks:
        m = float(blk["mass"])
        sel = (omega > blk["omega_min"]) & (omega < blk["omega_max"])
        om2 = (omega[sel] ** 2)[:, None]
        num = m ** 2 + dtau * om2 + 4.0 / dtau
        den = m ** 2 + dtau * om2 + (2.0 - 2.0 * np.cos(2 * np.pi * k / Ltau))[None, :] / dtau
        Q[sel] = num / den
    return Q


def build_mass(omega: np.ndarray, dtau: float, Ltau: int, blocks) -> np.ndarray:
    """HMC-convention dynamical-mass table."""
    omega = np.asarray(omega, dtype=np.float64)
    k = np.arange(Ltau)
    kp = np.minimum(k, Ltau - k)
    M = np.ones((omega.shape[0], Ltau))
    for blk in blocks:
        m0 = float(blk["mass"])
        c = float(blk.get("c", 0.0))
        sel = (omega > blk["omega_min"]) & (omega < blk["omega_max"])
        om2 = (omega[sel] ** 2)[:, None]
        mk = m0 * np.exp(-((c * kp / Ltau) ** 2))[None, :]
        num = dtau * (mk ** 2 + om2 + (2.0 - 2.0 * np.cos(2 * np.pi * kp / Ltau))[None, :] / dtau ** 2)
        den = mk ** 2 + om2
        M[sel] = num / den
    return M


# below this τ length the circulant matmul replaces the FFT pair (the JAX
# package's TPU-tuned crossover; an H100 measurement has to set it anew)
_CIRCULANT_MAX_LTAU = 256


def circulant(table: np.ndarray, power: float):
    """Per-UNIQUE-spectrum real circulants ``[U, Lτ, Lτ]``, the phonon rows
    of each spectrum, and the permutation that restores phonon order."""
    uniq, inv = np.unique(table, axis=0, return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    spec = uniq.astype(np.float64) ** power
    col = np.real(np.fft.ifft(spec, axis=-1))
    Lt = table.shape[-1]
    idx = (np.arange(Lt)[:, None] - np.arange(Lt)[None, :]) % Lt
    C = col[:, idx]
    groups = [np.where(inv == u)[0] for u in range(len(uniq))]
    unperm = np.argsort(np.concatenate(groups))
    return C, groups, unperm


class MassOperator:
    """``v ↦ F⁻¹·table^power·F·v`` along τ for a fixed set of powers, with
    everything the apply needs built once on ``device`` in ``dtype``."""

    def __init__(self, table, powers, device, dtype: torch.dtype):
        self.table = np.asarray(table, dtype=np.float64)
        self.Ltau = self.table.shape[-1]
        self.use_circulant = self.Ltau <= _CIRCULANT_MAX_LTAU
        self._ops = {}
        for p in powers:
            p = float(p)
            if self.use_circulant:
                C, groups, unperm = circulant(self.table, p)
                self._ops[p] = (
                    torch.as_tensor(C, device=device).to(dtype),
                    [torch.as_tensor(g, device=device) for g in groups],
                    torch.as_tensor(unperm, device=device))
            else:
                self._ops[p] = torch.as_tensor(self.table ** p, device=device).to(dtype)

    def apply(self, v: torch.Tensor, power: float) -> torch.Tensor:
        op = self._ops[float(power)]
        if not self.use_circulant:
            vw = torch.fft.fft(v, dim=-1) * op
            return torch.fft.ifft(vw, dim=-1).real.to(v.dtype)
        C, groups, unperm = op
        if len(groups) == 1:
            return torch.matmul(v, C[0])
        parts = [torch.matmul(v.index_select(-2, g), C[u]) for u, g in enumerate(groups)]
        return torch.cat(parts, dim=-2).index_select(-2, unperm)


def accelerate(table, v: torch.Tensor, power: float) -> torch.Tensor:
    """One-off ``v' = F⁻¹ · table^power · F · v`` along the last axis
    (builds the operator each call; hot loops hold a :class:`MassOperator`)."""
    return MassOperator(table, (power,), v.device, v.dtype).apply(v, power)
