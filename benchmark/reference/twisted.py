"""Complex hopping: the Holstein model with twisted boundaries and its HMC
update, in plain PyTorch.

A twist ``[θ₁, θ₂]`` (``[holstein] twist``) threads flux through the torus:
every bond of the rule with displacement dL takes the Peierls phase
e^{iφ}, φ = θ₁·dL₁/L + θ₂·dL₂/L. As the model defines it
(``models/holstein.py``, ``lattice.sort_neighbor_table``), the phase rides
the bond in its canonical order, smaller site first, whichever way the rule
ran; each group rotates its bonds (i < j) by the Hermitian block
[c s; s̄ c], c = cosh(Δτ·|t|), s = e^{iφ}·sinh(Δτ·|t|), so the first
endpoint takes s and the second its conjugate. The reversed fold is then
the adjoint, Mᵀ of :mod:`.models` becomes M† and B(τ)ᵀ becomes B(τ)†.

One departure from a flux of θ per winding, kept because the model has it:
a bond that wraps the boundary (site L−1 to site 0 along a row) is turned
round by the canonical order without conjugating its phase, so its phase
runs against the row's, and a winding collects θ·(L − 2)/L: up to a gauge,
the twist θ·(L − 2)/L. This is a defect of the model (the configuration's
``assumed.twist`` states the twist it applies); were the model fixed, this
reference would have to change with it.

The update (:class:`HMC`) is the real reference's (:mod:`.hmc`) on complex
fermion fields, as the port documents it (``utils/dtypes
.pseudofermion_noise``, ``dynamics/hmc.py``): the two spins' unit normals
R↑, R↓ packed as one field R = R↑ + i·R↓ ``[C, 1, N, Lτ]``, φ = Λ⁻¹·M†·R,
and H = ½·Re (Λφ)†(M†M)⁻¹(Λφ) + Sb(x) + ½·vᵀ·𝓜·v, which under the real
embedding is the two-spin action of the time-reversal-symmetric ensemble
|det M|². The solves are the reference's unpreconditioned CG on M†M seen as
a real operator on [re | im] (the inner product Re a†b), to 1e-7; the
force is autograd of Re zᴴ·Λ(x)φ − Re (Mz)ᴴ·M(x)·z with z held fixed.

Storage: ``dtype`` float64 runs the fermion fields in complex128. Under
bfloat16 (the lower-precision control) the real fields, tables and the
solves' vectors are bfloat16 and every complex value an operator returns
(each group's fold, M, M†, Λ, φ) is rounded to bfloat16 part by part,
since torch has no complex bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import hmc
from reference.models import Model, _eps


class TwistedModel(Model):
    """The Holstein model of the parsed input file ``cfg`` with its twist."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        super().__init__(cfg, device, dtype)
        if not self.holstein:
            raise ValueError("the twisted reference holds the Holstein model")
        m = cfg["holstein"]
        theta = np.zeros(3)
        theta[:len(m.get("twist", []))] = m.get("twist", [])
        Ls = np.array([self.L, self.L, 1.0])
        phase = []
        for d in m["t"]:
            dL = np.zeros(3)
            dL[:len(d["dL"])] = d["dL"]
            phase.append(np.exp(1j * float(np.sum(theta * dL / Ls))))
        # the sign of t rides the phase, as in the model's tables
        self.phase_bond = np.sign(self.t_bond) * np.asarray(phase)[self.bonds.definition]
        self.cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
        lo = self.bonds.pairs[0]
        self.first = [torch.as_tensor(np.arange(self.N) == lo[bond.cpu().numpy()],
                                      device=self.device)
                      for _, bond, _ in self.groups]

    def store(self, z):
        """A complex value as the model stores it: itself in complex128,
        each part rounded to bfloat16 under a bfloat16 model."""
        if self.dtype != torch.bfloat16:
            return z
        return torch.complex(z.real.to(self.dtype).float(), z.imag.to(self.dtype).float())

    def hopping(self, x):
        """(cosh(Δτ·|t|), e^{iφ}·sinh(Δτ·|t|)) per bond ``[Nb]``: the first
        real, the second complex."""
        arg = self.dtau * self.tensor(np.abs(self.t_bond))
        phase = torch.as_tensor(self.phase_bond, device=self.device).to(self.cdtype)
        return torch.cosh(arg), self.store(torch.sinh(arg) * phase)

    def coeffs(self, hop):
        """Per group: (partner, c, s) on the sites, s conjugated on each
        bond's second endpoint (1 and 0 where the group touches no bond)."""
        c_b, s_b = hop
        out = []
        for (partner, bond, touched), first in zip(self.groups, self.first):
            c = torch.where(touched, c_b[bond], torch.ones_like(c_b[bond]))
            s = torch.where(first, s_b[bond], s_b[bond].conj())
            s = torch.where(touched, s, torch.zeros_like(s))
            out.append((partner, c[:, None], s[:, None]))
        return out

    def fold(self, coeffs, v, transpose: bool = False):
        for partner, c, s in (reversed(coeffs) if transpose else coeffs):
            v = self.store(torch.addcmul(c * v, s, v.index_select(-2, partner)))
        return v

    def sign(self):
        """ε(τ), real."""
        return _eps(self.Lt, torch.empty((), dtype=self.dtype, device=self.device))

    def mulM(self, der, v):
        return self.store(v - self.sign() * self.apply_B(der, torch.roll(v, 1, dims=-1)))

    def mulMT(self, der, u):
        """M†·u (the base class's Mᵀ with Hermitian bond blocks)."""
        return self.store(u - torch.roll(self.sign() * self.apply_BT(der, u), -1, dims=-1))

    def lam_phi(self, x, phi):
        return self.store(super().lam_phi(x, phi))

    def phi_from(self, x, R):
        return self.store(super().phi_from(x, R.to(self.cdtype)))

    # --- the real embedding [re | im] along τ, for the solves ------------

    def real_view(self, z):
        """``[..., N, Lτ]`` complex → ``[..., N, 2Lτ]`` real (re, im
        interleaved) in the model's dtype."""
        return torch.view_as_real(z).flatten(-2).to(self.dtype)

    def complex_view(self, w):
        real = torch.float64 if self.dtype == torch.float64 else torch.float32
        return torch.view_as_complex(w.to(real).unflatten(-1, (self.Lt, 2)).contiguous())


class HMC(hmc.HMC):
    """The reference's update on the complex fermion fields of a
    :class:`TwistedModel`."""

    def solve(self, x, Lphi, guess=None):
        m = self.model
        der = m.derived(x)
        z, it = hmc.cg(lambda w: m.real_view(m.mulMTM(der, m.complex_view(w))),
                       m.real_view(Lphi), None if guess is None else m.real_view(guess),
                       self.tol, self.maxiter, m.acc)
        self.iterations += it
        return m.complex_view(z)

    def force(self, x, phi, z):
        """∂/∂x of ½·Re (Λφ)†(M†M)⁻¹(Λφ) at x, z = (M†M)⁻¹Λφ."""
        m = self.model
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            zd = z.detach()
            Mz = m.mulM(m.derived(x.detach()), zd).detach()
            g = ((zd.conj() * m.lam_phi(xg, phi)).real.sum()
                 - (Mz.conj() * m.mulM(m.derived(xg), zd)).real.sum())
            (F,) = torch.autograd.grad(g, xg)
        return F.to(m.dtype)

    def action(self, x, Lphi, z):
        m = self.model
        return hmc.dot(m.real_view(Lphi), m.real_view(z), m.acc).sum(dim=1) / 2 + m.Sb(x)

    def refresh(self, x0, momentum, eta):
        m = self.model
        return self.mass.apply(momentum.to(m.dtype), -0.5), m.phi_from(x0, eta)
