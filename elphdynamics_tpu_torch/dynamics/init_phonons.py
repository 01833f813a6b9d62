"""Initial phonon-field configurations.

Counterpart of ``elphdynamics_tpu/dynamics/init_phonons.py``: worldlines
flat in τ, drawn from the quantum-harmonic-oscillator width
σ = 1/√(2ω·tanh(βω/2)), with a model-specific offset:

* Holstein: (λ/ω²)·u with u uniform on {−1, 0, +1} (a site prepared near
  density 0, 1 or 2);
* SSH: −2α/ω² on phonon types without aliases, then aliased worldlines
  tied to their primary.
"""

from __future__ import annotations

import numpy as np
import torch

from elphdynamics_tpu_torch.models.adapter import ModelOps, global_phonons, local_phonons


def _qho_sigma(omega: torch.Tensor, beta: float) -> torch.Tensor:
    safe = torch.where(omega > 0, omega, torch.ones_like(omega))
    sig = 1.0 / torch.sqrt(2.0 * safe * torch.tanh(beta * safe / 2.0))
    return torch.where(omega > 0, sig, torch.ones_like(sig))


def init_phonons_half_filled(ops: ModelOps, params, n_chains: int,
                             generator: torch.Generator | None = None,
                             draws: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Initial ``x`` ``[C, Nph, Lτ]``. ``draws`` = (unit normals ``[C, Nph]``,
    integers in {−1, 0, 1} ``[C, Nph]``, or None for SSH, which draws
    none) replaces the generator's draws."""
    dev, dt = params.omega.device, params.omega.dtype
    if draws is None:
        # a site-sharded Holstein model draws every site's numbers and keeps
        # its block (SSH's bond field is whole on every rank)
        N = global_phonons(ops)
        normals = torch.randn((n_chains, N), generator=generator, dtype=dt, device=dev)
        ints = (torch.randint(-1, 2, (n_chains, N), generator=generator, device=dev)
                if ops.is_holstein else None)
        normals = local_phonons(ops, normals, -1)
        ints = None if ints is None else local_phonons(ops, ints, -1)
    else:
        normals, ints = draws
    sigma = _qho_sigma(params.omega, ops.beta)
    base = sigma * normals.to(device=dev, dtype=dt)
    om2 = torch.where(params.omega != 0, params.omega ** 2, torch.ones_like(params.omega))
    if ops.is_holstein:
        x0 = base + (params.lam / om2) * ints.to(device=dev, dtype=dt)
    else:
        prim = ops.spec.primary_phonon
        unique = torch.as_tensor(np.bincount(prim, minlength=ops.Nph)[prim] == 1,
                                 device=dev).to(dt)
        x0 = (base - unique * 2.0 * params.alpha / om2)[:, torch.as_tensor(prim, device=dev)]
    return x0[:, :, None].expand(-1, -1, ops.Ltau).contiguous()
